"""Quickstart on the PyTorch/CUDA port: the paper's data structure, then
durable elastic serving — ``examples/quickstart.py`` line for line on
``repro_torch``, the same sizes and seeds, so it prints the same numbers.

Part 1 builds an online sparse Markov chain, streams transitions into it,
queries "items until cumulative probability >= t", and decays it — the full
MCPrioQ API surface.

Part 2 is the production story (DESIGN.md §10): the same chain behind the
sharded serving engine with snapshots and a write-ahead log — save, kill
the "process", and restore **at a different shard count**, getting the
same answers back.  The port's shards are logical shards of one device, so
the 4 -> 2 restore needs no second device.

Part 3 is kill-under-load (DESIGN.md §12): arm fault-injection failpoints
on the live write path and watch the retry ladder absorb a transient disk
flake, a persistent ENOSPC poison writes while reads keep serving, and
``restore()`` heal the poisoned engine bit-exactly.

Part 4 is telemetry (DESIGN.md §13): arm the lock-free metrics registry,
scrape the Prometheus surface ``launch/serve.py --metrics-port`` serves
(latency quantiles, per-bucket traffic), provoke a write-path poison, and
read the flight recorder's incident dump.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--chaos]

``--chaos`` additionally runs the real crash soak: a serving subprocess
SIGKILLed mid-append/mid-snapshot a few times, each death verified
bit-exact against a deterministic replay oracle (``repro_torch.chaos.soak``).
"""

import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.core import mcprioq as mc
from repro_torch.core import sharded as sh
from repro_torch.data.synthetic import MarkovGraphSampler
from repro_torch.serve.engine import ShardedEngine, ShardedServeConfig

# where the chains and engines live: None is the GPU (set from --device)
DEVICE = None


def host(x) -> np.ndarray:
    return x.cpu().numpy()


def part1_the_data_structure():
    # a ground-truth random graph with Zipf(1.8) edge probabilities
    graph = MarkovGraphSampler(num_nodes=200, out_degree=16, zipf_s=1.8,
                               seed=0)

    cfg = mc.MCConfig(
        num_rows=256,     # max distinct src nodes tracked
        capacity=32,      # max out-edges kept per node (Space-Saving beyond)
        sort_passes=1,    # odd-even passes per update batch ("bubble sort")
    )
    state = mc.init(cfg, device=DEVICE)

    # ---- online learning: stream transition batches -----------------------
    for step in range(50):
        src, dst = graph.sample_transitions(512)
        state = mc.update_batch(state, src, dst, cfg=cfg)
    print("invariants:", mc.check_invariants(state))

    # ---- the paper's query: recommend until P(match) >= 0.9 ---------------
    node = np.asarray([7], np.int32)
    dsts, probs, n_needed = mc.query_threshold(state, node, 0.9, cfg=cfg,
                                               max_items=16)
    true_dsts, true_probs = graph.true_probs(7)
    print(f"\nnode 7 needs {int(n_needed[0])} items to reach t=0.9 "
          f"(CDF^-1 of its Zipf edges)")
    print("learned:", [(int(d), round(float(p), 3))
                       for d, p in zip(dsts[0], probs[0]) if d >= 0][:5])
    print("truth  :", [(int(d), round(float(p), 3))
                       for d, p in zip(true_dsts[:5], true_probs[:5])])

    # ---- model decay (§II.C): halve counts, evict dead edges --------------
    live_before = int((state.slabs.cnt > 0).sum())
    state = mc.decay(state, cfg=cfg)
    live_after = int((state.slabs.cnt > 0).sum())
    print(f"\ndecay: {live_before} -> {live_after} live edges "
          f"(distribution preserved, cold edges evicted)")


def part2_durable_elastic_serving():
    """save -> kill -> restore at a different shard count (DESIGN.md §10)."""
    snap_dir = tempfile.mkdtemp(prefix="mcprioq-snap-")
    wal_dir = tempfile.mkdtemp(prefix="mcprioq-wal-")
    base = mc.MCConfig(num_rows=512, capacity=32, sort_passes=4)
    graph = MarkovGraphSampler(num_nodes=300, out_degree=12, zipf_s=1.5,
                               seed=3)

    def engine_at(num_shards):
        return ShardedEngine(ShardedServeConfig(
            sharded=sh.ShardedConfig(base=base, num_shards=num_shards,
                                     bucket_factor=4.0),
            decay_threshold=1 << 30,
            snapshot_dir=snap_dir,   # arms checkpoint()/restore()
            wal_dir=wal_dir,         # every batch durably logged pre-apply
            snapshot_every=4),       # background snapshot every 4 observes
            device=DEVICE)

    # every learned edge of a row, order-canonicalised: elastic restore
    # conserves counts exactly but *settles* the order permutation, while a
    # live chain's order is only approximately sorted (A2) — so the
    # order-independent view is what must match across the kill
    def canonical_edges(engine, queries):
        d, p, n = engine.query(queries, threshold=0.999999, max_items=32)
        d, p = host(d), host(p)
        key = np.lexsort((d, -p), axis=-1)
        return (np.take_along_axis(d, key, 1),
                np.take_along_axis(p, key, 1), host(n))

    # ---- serve at N=4 shards: observe, snapshot on cadence ----------------
    engine = engine_at(4)
    for _ in range(6):
        src, dst = graph.sample_transitions(1024)
        engine.observe(src, dst)
    engine.checkpoint()              # explicit snapshot (cadence also ran)
    src, dst = graph.sample_transitions(1024)
    engine.observe(src, dst)         # after the snapshot: WAL-only
    queries = np.arange(32, dtype=np.int32)
    before = canonical_edges(engine, queries)
    print(f"\nserved {engine.stats['updates']} batches at 4 shards, "
          f"{engine.stats['snapshots']} snapshots, "
          f"WAL through seq {engine._seq}")

    # ---- kill: drop every in-memory reference -----------------------------
    del engine                       # all device + host state is gone

    # ---- restore at M=2 shards: elastic reshard + WAL replay --------------
    revived = engine_at(2)
    info = revived.restore()
    print(f"restored snapshot step {info['step']} at 2 shards "
          f"(mode={info['mode']}, replayed {info['replayed']} WAL batches)")
    after = canonical_edges(revived, queries)
    same = all(np.array_equal(a, b) for a, b in zip(before, after))
    print(f"learned edges after elastic restore match pre-kill chain: {same}")
    assert same

    shutil.rmtree(snap_dir)
    shutil.rmtree(wal_dir)


def part3_kill_under_load():
    """faults on the live write path: retry -> poison -> restore-heal
    (DESIGN.md §12)."""
    import errno

    from repro_torch import faults
    from repro_torch.runtime.fault_tolerance import (EngineWriteUnavailable,
                                                     RetryPolicy)

    snap_dir = tempfile.mkdtemp(prefix="mcprioq-chaos-snap-")
    wal_dir = tempfile.mkdtemp(prefix="mcprioq-chaos-wal-")
    base = mc.MCConfig(num_rows=256, capacity=16, sort_passes=2)
    graph = MarkovGraphSampler(num_nodes=200, out_degree=12, zipf_s=1.5,
                               seed=7)

    def engine():
        return ShardedEngine(ShardedServeConfig(
            sharded=sh.ShardedConfig(base=base, num_shards=1,
                                     bucket_factor=4.0),
            decay_threshold=1 << 30, snapshot_dir=snap_dir, wal_dir=wal_dir,
            wal_fsync="always",
            retry=RetryPolicy(max_attempts=3, base_delay_s=1e-3)),
            device=DEVICE)

    eng = engine()
    batches = [graph.sample_transitions(512) for _ in range(4)]
    eng.observe(*batches[0])
    eng.checkpoint()

    # ---- a transient disk flake: the retry ladder absorbs it --------------
    faults.arm("wal.append.write", faults.FaultInjected("wal.append.write"),
               count=1)
    eng.observe(*batches[1])
    print(f"\ntransient WAL fault: retried {eng.stats['wal_retries']}x, "
          f"batch applied (updates={eng.stats['updates']}), "
          f"write_available={eng.write_available}")

    # ---- persistent ENOSPC: writes poison, reads keep serving -------------
    faults.arm("wal.append.write",
               faults.FaultInjected("wal.append.write", errno.ENOSPC))
    try:
        eng.observe(*batches[2])
    except EngineWriteUnavailable as e:
        print(f"persistent fault escalated: {e}")
    faults.reset()
    queries = np.arange(32, dtype=np.int32)
    before = eng.query(queries, threshold=0.9, max_items=16)
    print(f"poisoned engine still answers reads "
          f"(write_available={eng.write_available}, "
          f"write_errors={eng.stats['write_errors']})")

    # ---- kill + restore: replay heals the poison --------------------------
    # the poison took a best-effort snapshot on a worker thread; wait for
    # its commit (close() drains it), so the restore below finds the same
    # step whatever the disk's speed (the reference's slower read leaves it
    # the time)
    eng.close()
    del eng
    revived = engine()
    info = revived.restore()
    after = revived.query(queries, threshold=0.9, max_items=16)
    same = all(np.array_equal(host(a), host(b))
               for a, b in zip(before, after))
    print(f"restored step {info['step']}, replayed {info['replayed']} WAL "
          f"batches: write_available={revived.write_available}, "
          f"pre-kill answers match: {same}")
    assert same and revived.write_available

    shutil.rmtree(snap_dir)
    shutil.rmtree(wal_dir)


def part4_telemetry_and_flight_recorder():
    """armed telemetry: scrape the /metrics surface, provoke a poison,
    read the flight-recorder incident dump (DESIGN.md §13)."""
    import errno
    import json
    import urllib.request

    from repro_torch import faults
    from repro_torch.obs import metrics as obs
    from repro_torch.obs.export import MetricsServer
    from repro_torch.runtime.fault_tolerance import (EngineWriteUnavailable,
                                                     RetryPolicy)

    wal_dir = tempfile.mkdtemp(prefix="mcprioq-obs-wal-")
    incident_dir = tempfile.mkdtemp(prefix="mcprioq-obs-inc-")
    base = mc.MCConfig(num_rows=256, capacity=16, sort_passes=2)
    graph = MarkovGraphSampler(num_nodes=200, out_degree=12, zipf_s=1.5,
                               seed=11)

    obs.arm()               # histograms/spans/vectors/incidents on
    try:
        eng = ShardedEngine(ShardedServeConfig(
            sharded=sh.ShardedConfig(base=base, num_shards=1,
                                     bucket_factor=4.0),
            decay_threshold=1 << 30, wal_dir=wal_dir, wal_fsync="always",
            incident_dir=incident_dir,
            retry=RetryPolicy(max_attempts=3, base_delay_s=1e-3)),
            device=DEVICE)
        for _ in range(4):
            eng.observe(*graph.sample_transitions(512))
        eng.query(np.arange(32, dtype=np.int32), threshold=0.9,
                  max_items=16)

        # ---- scrape the same surface `launch/serve.py --metrics-port`
        # serves: latency quantiles + per-virtual-bucket traffic ----------
        server = MetricsServer(eng.metrics, port=0).start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/metrics") as resp:
                text = resp.read().decode()
        finally:
            server.close()
        shown = [ln for ln in text.splitlines()
                 if ln.startswith(("mcq_engine_observe_seconds{",
                                   "mcq_engine_query_seconds{",
                                   "mcq_bucket_traffic{"))]
        print("\nscraped /metrics (observe/query quantiles, bucket "
              "traffic):")
        for ln in shown[:8]:
            print("  " + ln)

        # ---- provoke a fault: persistent ENOSPC poisons the write path --
        faults.arm("wal.append.write",
                   faults.FaultInjected("wal.append.write", errno.ENOSPC))
        try:
            eng.observe(*graph.sample_transitions(512))
        except EngineWriteUnavailable:
            pass
        faults.reset()

        # ---- the flight recorder dumped the incident --------------------
        dumps = sorted(os.listdir(incident_dir))
        with open(os.path.join(incident_dir, dumps[0])) as fh:
            incident = json.load(fh)
        print(f"incident dump {dumps[0]}: reason={incident['reason']!r}, "
              f"{len(incident['spans'])} flight-recorder spans, "
              f"{len(incident['deltas'])} scalar deltas since baseline")
        assert incident["schema"] == "mcq-incident-v1" and incident["spans"]
    finally:
        obs.disarm()
        faults.reset()
    shutil.rmtree(wal_dir)
    shutil.rmtree(incident_dir)


def chaos_soak_demo(kills=3):
    """the real thing: SIGKILL a serving subprocess, verify bit-exact
    recovery against the deterministic replay oracle
    (repro_torch.chaos.soak), the workers on this example's device."""
    from repro_torch.chaos.soak import run_soak
    result = run_soak(kills, rows=128, batch=64, snapshot_every=3,
                      device="cuda" if DEVICE is None else DEVICE)
    assert result["ok"], "crash soak diverged"
    print(f"\nchaos soak: {kills} kills, all recoveries bit-exact")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the chains and engines live (default: the "
                         "GPU)")
    ap.add_argument("--chaos", action="store_true",
                    help="also run the crash soak (3 kills)")
    args = ap.parse_args()
    DEVICE = None if args.device == "cuda" else args.device
    part1_the_data_structure()
    part2_durable_elastic_serving()
    part3_kill_under_load()
    part4_telemetry_and_flight_recorder()
    if args.chaos:
        chaos_soak_demo()
