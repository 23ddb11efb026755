"""One rank of the serving engine's rank group, on the CPU over gloo.

    python tests/torch_engine_ranks_worker.py <rank> <world> <workdir>

``tests/test_torch_engine_ranks.py`` starts ``world`` of these at once.
Each joins the group by a ``file://`` rendezvous in ``workdir``, reads
``spec.json`` and runs, in turn:

  * every scenario named there from ``torch_engine_scenarios`` through
    :class:`RanksPkg` (``ShardedEngine(cfg, ranks=group)``; a state is the
    group's gathered on rank 0), at ``shards=world``, the scenario's own
    claims checked on every rank;
  * ``elastic``: as the writer, ``elastic_restore``'s 4-shard part (its
    snapshot, a WAL record after it, its exact restore), then a file that
    says so; as a reader, that file awaited, the writer's directory copied
    and restored onto this group's shard count;
  * ``mixed_order``: two observes issued in opposite orders on even and
    odd ranks (as two threads' calls taken in different orders), each
    raising the named ``RankDisagreement``;
  * ``lane``: a reader lane's queries run while the writer reassigns
    every bucket one shard on, rank 1's swap held back so that the lanes'
    ranks read under different route epochs; every answer recorded;
  * ``kill``: rank 1 leaves the process without a word, and rank 0's
    next observe and query raise, naming the call, in the seconds
    recorded.

It writes what it recorded to ``workdir/rank<r>.npz``.  Nothing here
imports JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import torch_engine_scenarios as es  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.persist import reshard as rs  # noqa: E402
from repro_torch.sharding.ranks import RankGroupLost, init_ranks  # noqa: E402

LANE_READS = 60        # queries of the lane test, on every rank
LANE_PACE_S = 0.01     # between two of them
LANE_HOLD_S = 0.3      # rank 1's swap held back by this much


class RanksPkg(es.Pkg):
    """The port's package with every engine ``ShardedEngine(cfg,
    ranks=group)``; a state is the group's, gathered to rank 0 (every
    rank calls; the other ranks get no leaves)."""

    def __init__(self, group):
        port = es.port()
        super().__init__("port", port.mc, port.sh, port.engine_mod,
                         port.Ownership, port.ft, port.faults, port.obs,
                         port.snapshot_io, port.serve, port._leaves, {})
        self.group = group

    def engine(self, cfg):
        return self.engine_mod.ShardedEngine(cfg, ranks=self.group)

    def state(self, eng):
        snap = eng.store.acquire()
        try:
            stacked = convert.gather_sharded(snap.state, eng.ranks, 0)
        finally:
            eng.store.release(snap)
        if stacked is None:
            return {}
        return {k: np.array(v) for k, v in self._leaves(stacked).items()}


def reset(pkg) -> None:
    pkg.faults.reset()
    pkg.faults.set_observer(None)
    pkg.obs.disarm()


def scenario(pkg, name, tmp, out, **kw) -> None:
    os.makedirs(tmp, exist_ok=True)
    rec = {}
    reset(pkg)
    try:
        es.SCENARIOS[name](pkg, str(tmp), rec, **kw)
    finally:
        reset(pkg)
    out.update({f"{name}/{k}": v for k, v in rec.items()})


def await_file(path: Path, deadline: float) -> None:
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)


def mixed_order(pkg, group, out) -> None:
    """Batch a then b on even ranks, b then a on odd ones: the first
    observe raises ``RankDisagreement`` on every rank, nothing applied;
    the same call on every rank then applies."""
    eng = es.serve_engine(pkg, group.world)
    a = es.batch(0)
    b = es.batch(1)
    first = a if group.rank % 2 == 0 else b
    try:
        eng.observe(*first)
    except pkg.engine_mod.RankDisagreement as exc:
        out["mixed/error"] = np.array(f"{type(exc).__name__}: {exc}")
    else:
        raise AssertionError("observes in opposite orders were applied")
    out["mixed/version_after"] = np.int64(eng.store.version)
    eng.observe(*a)
    out["mixed/version_then"] = np.int64(eng.store.version)
    eng.close()


def lane_through_reassign(pkg, group, out, work: Path) -> None:
    """A reader lane's queries while the writer reassigns every bucket one
    shard on; rank 1's swap waits ``LANE_HOLD_S`` after its re-ingest, so
    the lane's ranks pin states of two maps.  Every answer is recorded
    (the test holds each to the answers before the reassign)."""
    world = group.world
    eng = es.persist_engine(pkg, str(work / "lane"),
                            wal=False, num_shards=world)
    eng.observe(*es.distinct_count_batch())
    q = np.arange(12, dtype=np.int32)
    before = [x.numpy() for x in eng.query(q)]
    own = pkg.Ownership(num_shards=world, num_buckets=64, assignment=tuple(
        (b + 1) % world for b in range(64)))
    settle = rs.settle_order_
    if group.rank == 1:
        def held(state):
            out_state = settle(state)
            time.sleep(LANE_HOLD_S)
            return out_state
        rs.settle_order_ = held
    got, errors = [], []

    def reads():
        try:
            for _ in range(LANE_READS):
                got.append([x.numpy() for x in eng.query(q, lane=0)])
                time.sleep(LANE_PACE_S)
        except BaseException as exc:   # raised again below
            errors.append(exc)

    group.agree([0])                   # every rank starts together
    thread = threading.Thread(target=reads)
    thread.start()
    try:
        eng.reassign(own)
    finally:
        rs.settle_order_ = settle
    thread.join()
    if errors:
        raise errors[0]
    out["lane/before"] = np.stack([np.concatenate(
        [x.reshape(x.shape[0], -1).astype(np.float64) for x in before],
        axis=1)])
    out["lane/reads"] = np.stack([np.concatenate(
        [x.reshape(x.shape[0], -1).astype(np.float64) for x in r], axis=1)
        for r in got])
    out["lane/route_retries"] = np.int64(eng.read_route_retries)
    out["lane/epoch"] = np.int64(eng._route_epoch)
    eng.close()


def kill(pkg, group, out, work: Path) -> None:
    """Rank 1 ends its process at once; rank 0's next observe and query
    raise, naming the call."""
    eng = es.serve_engine(pkg, group.world)
    eng.observe(*es.batch(0))
    group.agree([0])
    if group.rank == 1:
        np.savez(work / "rank1.npz", **out)
        os._exit(0)
    if group.rank != 0:
        return
    time.sleep(0.5)
    t0 = time.monotonic()
    try:
        eng.observe(*es.batch(1))
    except pkg.ft.EngineWriteUnavailable as exc:
        out["kill/observe"] = np.array(str(exc))
    out["kill/observe_s"] = np.float64(time.monotonic() - t0)
    try:
        eng.query(np.arange(8, dtype=np.int32))
    except RankGroupLost as exc:
        out["kill/query"] = np.array(str(exc))
    out["kill/write_available"] = np.bool_(eng.write_available)


def main(rank: int, world: int, work: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((work / "spec.json").read_text())
    deadline = time.monotonic() + spec["limit_s"]
    group = init_ranks(rank, world, backend="gloo",
                       init_method=f"file://{work / 'rendezvous'}",
                       device="cpu", timeout=spec["timeout_s"])
    pkg = RanksPkg(group)
    out = {}
    for name in spec["scenarios"]:
        scenario(pkg, name, work / name, out, shards=world)
    elastic = spec.get("elastic")
    if elastic and elastic["role"] == "write":
        scenario(pkg, "elastic_restore", Path(elastic["dir"]), out,
                 shards=world, targets=())
        group.agree([0])
        if rank == 0:
            Path(elastic["ready"]).write_text("ready")
    if "mixed_order" in spec["extras"]:
        mixed_order(pkg, group, out)
    if "lane" in spec["extras"]:
        lane_through_reassign(pkg, group, out, work)
    if elastic and elastic["role"] == "read":
        await_file(Path(elastic["ready"]), deadline)
        mine = work / "elastic_restore"
        if rank == 0:
            shutil.copytree(elastic["dir"], mine)
        group.agree([0])
        scenario(pkg, "elastic_restore", mine, out, shards=4,
                 targets=(world,), write=False)
    if "kill" in spec["extras"]:
        kill(pkg, group, out, work)
        np.savez(work / f"rank{rank}.npz", **out)
        os._exit(0)
    np.savez(work / f"rank{rank}.npz", **out)
    group.agree([0])      # every rank past its last collective
    # end without tearing the groups down: a rank's gloo teardown racing
    # its peers' exits can abort the process after its work is done
    os._exit(0)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
