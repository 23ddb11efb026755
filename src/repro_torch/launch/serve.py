"""Serving launcher of the port: batched LM requests through the ``Engine``
with the MCPrioQ speculative drafter, or shard-parallel chain serving.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --requests 4 --prompt-len 32 --new-tokens 32

serves ``qwen2-7b`` at full width with random parameters (float32, about
30.5 GB, bfloat16 compute) on the GPU; ``--smoke --device cpu`` serves its
reduced config on the CPU.  ``--arch deepseek-moe-16b`` (65.5 GB of float32
parameters), ``--arch mamba2-130m`` and ``--arch recurrentgemma-9b`` serve
the MoE, SSM and hybrid families the same way (``moonshot-v1-16b-a3b``,
113.6 GB, does not fit one 80 GB card; ``--smoke`` serves it).  The encoder
and vision archs (``whisper-base``, ``phi-3-vision-4.2b``) are refused as
the reference refuses them: the ``Engine`` feeds neither frames nor patch
embeddings (``models.Model`` runs both).

Shard-parallel chain serving routes synthetic transition traffic through
the port's :class:`repro_torch.serve.engine.ShardedEngine` (the S shards
are logical shards of one GPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --num-shards 8 \
      --bucket-factor 2.0 --requests 16 --route-batch 4096

Durable serving — snapshot on cadence, write-ahead-log every batch, and
recover (optionally at a different shard count) with --restore:

  ... --num-shards 8 --snapshot-dir /tmp/mc-snap --snapshot-every 8 \
      --wal /tmp/mc-wal
  ... --num-shards 4 --snapshot-dir /tmp/mc-snap --wal /tmp/mc-wal --restore

One shard a process rank — ``--ranks nccl`` (one card a rank) or
``--ranks gloo`` (every rank on the current card, host-staged; with
``--device cpu`` on the CPU) — spawns ``--num-shards`` rank processes that
join one group by a ``file://`` rendezvous in a fresh directory, each
serving its shard through ``ShardedEngine(cfg, ranks=group)``; rank 0
alone prints, and the launcher exits non-zero naming the first rank that
failed:

  PYTHONPATH=src python -m repro_torch.launch.serve --num-shards 4 \
      --ranks nccl

Counterpart of ``repro.launch.serve``'s ``run``, ``run_sharded`` and
``main``.  Both serve on the GPU unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import functools
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import mcprioq as mc
from repro_torch.core import sharded as sh
from repro_torch.core import speculative as spec
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import MarkovGraphSampler
from repro_torch.models.model import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.export import MetricsDumper, MetricsServer
from repro_torch.serve.engine import (Engine, ServeConfig, ShardedEngine,
                                      ShardedServeConfig)


def run(arch: str, smoke: bool, requests: int, prompt_len: int,
        new_tokens: int, draft_len: int, seed: int = 0,
        decay_threshold: int = 1 << 18, decay_block_rows: int = 1024,
        device=None):
    """Serve ``requests`` batches of 2 random prompts through the LM
    ``Engine`` on ``device`` (default: the GPU; an error without one), the
    model's parameters random from ``seed``.  Returns (outputs, engine)."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg.encoder_layers or cfg.frontend == "patch":
        raise SystemExit("text-LM serving driver; see examples/ for encdec")
    dev = resolve_device(device)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    # rolling decay keeps learner-side maintenance bounded per request
    # (DESIGN.md §6) instead of stalling serving on a full-table sweep
    mc_cfg = mc.MCConfig(num_rows=8192, capacity=64, sort_passes=1,
                         decay_block_rows=decay_block_rows)
    scfg = ServeConfig(
        max_new_tokens=new_tokens,
        max_cache_len=prompt_len + new_tokens + 8,
        draft_len=draft_len,
        ngram=spec.NGramConfig(order=2, mc=mc_cfg,
                               decay_threshold=decay_threshold),
    )
    engine = Engine(model, params, scfg, device=dev)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    outs = []
    for r in range(requests):
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (2, prompt_len)).astype(np.int32)}
        outs.append(engine.generate(
            batch, torch.Generator(device=dev).manual_seed(r)))
    dt = time.time() - t0
    total_tokens = sum(o.size for o in outs)
    plain_calls = requests * (new_tokens - 1)
    print(f"{requests} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s)")
    print(f"model calls {engine.stats['model_calls']} "
          f"(plain greedy would use {plain_calls}), "
          f"draft acceptance {engine.acceptance_rate:.2%}")
    print(f"maintenance: decay_steps={engine.stats['decay_steps']} "
          f"dh_rebuilds={engine.stats['dh_rebuilds']} "
          f"dh_tombstones={engine.stats['dh_tombstones']}")
    return outs, engine


def run_sharded(num_shards: int, bucket_factor: float, requests: int,
                route_batch: int, topn: int, seed: int = 0,
                decay_threshold: int = 1 << 18, decay_block_rows: int = 1024,
                snapshot_dir: str = "", snapshot_every: int = 0,
                wal_dir: str = "", restore: bool = False,
                route_retry_budget: int = 0, query_retry_budget: int = 0,
                health_strikes: int = 3, failpoints: str = "",
                metrics_port: int = -1, metrics_dump: str = "",
                metrics_every: float = 5.0, incident_dir: str = "",
                metrics_linger: float = 0.0, device=None, ranks=None):
    """Shard-parallel chain serving: route synthetic Zipf transition traffic
    through the ShardedEngine (observe + query per request) and report
    throughput plus the routing/overflow counters.  With a snapshot dir the
    engine checkpoints on cadence (and a WAL makes recovery exact);
    ``restore=True`` recovers from the newest complete snapshot first —
    elastically, if it was taken at a different shard count (DESIGN.md §10).
    ``failpoints`` arms injection sites (same spec as ``MCQ_FAILPOINTS``,
    DESIGN.md §12) so the retry/degradation ladder can be driven live.
    ``metrics_port >= 0`` serves Prometheus text at ``/metrics`` (0 picks an
    ephemeral port, printed at startup); ``metrics_dump`` writes JSONL images
    on a ``metrics_every`` cadence (DESIGN.md §13).  ``device=None`` serves
    on the GPU (an error without one).  With ``ranks`` (a
    ``sharding.ranks.RankGroup`` of world ``num_shards``; every rank calls
    with the same arguments) this process serves shard ``ranks.rank``;
    rank 0 alone prints and serves the metrics."""
    lead = ranks is None or ranks.rank == 0
    say = print if lead else _quiet
    if failpoints:
        from repro_torch.faults import arm_from_env
        n = arm_from_env(failpoints)
        say(f"armed {n} failpoint(s): {failpoints}")
    telemetry = metrics_port >= 0 or bool(metrics_dump) or bool(incident_dir)
    if telemetry:
        obs_metrics.arm()
    base = mc.MCConfig(num_rows=4096, capacity=64, sort_passes=1,
                       decay_block_rows=decay_block_rows)
    scfg = sh.ShardedConfig(base=base, num_shards=num_shards,
                            bucket_factor=bucket_factor)
    engine = ShardedEngine(ShardedServeConfig(
        sharded=scfg, decay_threshold=decay_threshold, topn=topn,
        snapshot_dir=snapshot_dir or None, snapshot_every=snapshot_every,
        wal_dir=wal_dir or None,
        route_retry_budget=route_retry_budget,
        query_retry_budget=query_retry_budget,
        health_strikes=health_strikes,
        incident_dir=incident_dir or None), device=device, ranks=ranks)
    server = dumper = None
    if metrics_port >= 0 and lead:
        server = MetricsServer(engine.metrics, port=metrics_port).start()
        say(f"metrics: http://127.0.0.1:{server.port}/metrics", flush=True)
    if metrics_dump and lead:
        dumper = MetricsDumper(engine.metrics, metrics_dump,
                               every_s=metrics_every).start()
    if restore:
        info = engine.restore()
        say(f"restored step {info['step']} ({info['mode']}), "
              f"replayed {info['replayed']} WAL batches "
              f"through seq {info['wal_seq']}")
    graph = MarkovGraphSampler(num_nodes=4096, out_degree=32, seed=seed)
    rng = np.random.default_rng(seed)
    # build the kernels outside the timed loop (built once per process)
    s, d = graph.sample_transitions(route_batch)
    engine.observe(s, d)
    engine.query(rng.integers(0, 4096, 256).astype(np.int32))
    t0 = time.time()
    for _ in range(requests):
        s, d = graph.sample_transitions(route_batch)
        engine.observe(s, d)
        engine.query(rng.integers(0, 4096, 256).astype(np.int32))
    dt = time.time() - t0
    edges = requests * route_batch
    srcs, dsts, probs = (x.cpu().numpy() for x in engine.topn())
    st = engine.stats_snapshot()
    say(f"{requests} requests, {edges} edges over {num_shards} shards "
          f"in {dt:.1f}s ({edges / dt:.0f} edges/s)")
    say(f"routing: route_dropped={st['route_dropped']} "
          f"query_dropped={st['query_dropped']} "
          f"dropped_rows={st['dropped_rows']} "
          f"deferred_new={st['deferred_new']}")
    say(f"faults: wal_retries={st['wal_retries']} "
          f"apply_retries={st['apply_retries']} "
          f"dispatch_retries={st['dispatch_retries']} "
          f"write_errors={st['write_errors']} "
          f"degraded_answers={st['degraded_answers']} "
          f"route_retried={st['route_retried']}/"
          f"lost={st['route_lost']} "
          f"shards_down={st['shards_down']} "
          f"write_available={engine.write_available}")
    say(f"maintenance: decay_steps={st['decay_steps']} "
          f"n_rows={st['n_rows']} snapshots={st['snapshots']}")
    if snapshot_dir:
        path = engine.checkpoint()
        say(f"final checkpoint -> {path}")
    head = ", ".join(
        f"{int(s_)}->{int(d_)}:{float(p_):.3f}"
        for s_, d_, p_ in zip(srcs[:5], dsts[:5], probs[:5]))
    say(f"global top-{topn} head: {head} "
          f"(unexposed candidates {st['topn_dropped']})")
    if telemetry:
        snap = engine.metrics.snapshot()
        obs = snap["histograms"].get("engine.observe", {})
        qry = snap["histograms"].get("engine.query", {})
        say(f"telemetry: observe p50={obs.get('p50', 0.0):.4f}s "
              f"p99={obs.get('p99', 0.0):.4f}s "
              f"query p50={qry.get('p50', 0.0):.4f}s "
              f"p99={qry.get('p99', 0.0):.4f}s")
    if metrics_linger > 0 and server is not None:
        say(f"lingering {metrics_linger:.0f}s for scrapes...", flush=True)
        time.sleep(metrics_linger)
    if dumper is not None:
        dumper.close()
    if server is not None:
        server.close()
    return engine


def _quiet(*args, **kw):
    """The ``print`` of a rank other than 0."""


def _rank_main(rank: int, world: int, backend: str, rendezvous: str,
               device, kwargs: dict) -> None:
    """One spawned rank of :func:`serve_ranks`: join the group, serve
    through :func:`run_sharded`, wait for every rank, end."""
    from repro_torch.sharding.ranks import init_ranks
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # the ranks share the host's cores: one thread pool each would
    # oversubscribe them (spinning threads cost more than the work)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = init_ranks(rank, world, backend=backend, init_method=rendezvous,
                       device=device)
    engine = run_sharded(world, ranks=group, device=group.device, **kwargs)
    engine.close()
    group.agree([0])      # every rank past its last collective
    # end without tearing the groups down: a rank's gloo teardown racing
    # its peers' exits can abort the process after its work is done
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def serve_ranks(num_shards: int, backend: str, device=None, **kwargs) -> None:
    """Spawn ``num_shards`` rank processes of :func:`run_sharded` (one shard
    a rank; ``kwargs`` its arguments but the shard count and the device)
    over ``backend`` and wait for them.  NCCL takes cards 0..N-1, one a
    rank; gloo takes the current card (host-staged), or the CPU with
    ``device='cpu'``.  Raises ``SystemExit`` naming the first rank that
    failed, after killing the others."""
    import multiprocessing
    if backend == "nccl" and (device is not None and
                              torch.device(device).type != "cuda"):
        raise SystemExit("--ranks nccl serves one card a rank; drop --device")
    if backend == "nccl" and torch.cuda.device_count() < num_shards:
        raise SystemExit(f"--ranks nccl needs {num_shards} cards, "
                         f"{torch.cuda.device_count()} visible")
    if backend == "nccl":
        device = None    # cuda:<rank>
    ctx = multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="mcq_serve_ranks_")
    procs = [ctx.Process(target=_rank_main, name=f"rank {r}", args=(
        r, num_shards, backend, f"file://{work}/rendezvous", device, kwargs))
        for r in range(num_shards)]
    try:
        for p in procs:
            p.start()
        while True:
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise SystemExit(f"serve: rank {bad[0][0]} of {num_shards} "
                                 f"({backend}) exited with {bad[0][1]}")
            if all(p.exitcode == 0 for p in procs):
                return
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--draft-len", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="serve on this torch device (default: the GPU; "
                         "'cpu' runs the plain versions on the CPU)")
    ap.add_argument("--decay-threshold", type=int, default=1 << 18,
                    help="row-total threshold that triggers §II.C decay")
    ap.add_argument("--decay-block-rows", type=int, default=1024,
                    help="rolling decay block size; 0 = stop-the-world")
    ap.add_argument("--num-shards", type=int, default=0,
                    help="> 0 serves the node-sharded chain (ShardedEngine) "
                         "instead of the LM loop, that many logical shards "
                         "on one device")
    ap.add_argument("--ranks", choices=("gloo", "nccl"), default=None,
                    help="with --num-shards N: spawn N rank processes, one "
                         "shard a rank, over this backend (nccl: one card a "
                         "rank; gloo: the current card, or the CPU with "
                         "--device cpu)")
    ap.add_argument("--bucket-factor", type=float, default=2.0,
                    help="all_to_all bucket capacity as a multiple of the "
                         "fair per-shard share (overflow drops are counted)")
    ap.add_argument("--route-batch", type=int, default=2048,
                    help="transitions per sharded observe() call")
    ap.add_argument("--topn", type=int, default=16,
                    help="global top-n read size for the sharded path")
    ap.add_argument("--snapshot-dir", default="",
                    help="arm durable serving: checkpoint()/restore() + "
                         "cadence snapshots land here (DESIGN.md §10)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="background snapshot every N observe() calls "
                         "(0 = only the final/escalation checkpoints)")
    ap.add_argument("--wal", default="", dest="wal_dir",
                    help="write-ahead-log directory: every observed batch "
                         "is durably logged before it is applied, so "
                         "--restore replays to the exact pre-crash state")
    ap.add_argument("--restore", action="store_true",
                    help="recover from the newest complete snapshot before "
                         "serving (elastic if the snapshot's shard count "
                         "differs from --num-shards)")
    ap.add_argument("--route-retry-budget", type=int, default=0,
                    help="bounded re-submission budget for skew-dropped "
                         "routed items (0 = count them as route_dropped)")
    ap.add_argument("--query-retry-budget", type=int, default=0,
                    help="in-call re-dispatch rounds for skew-dropped "
                         "query items (0 = count them as query_dropped)")
    ap.add_argument("--health-strikes", type=int, default=3,
                    help="consecutive dispatch failures before a shard is "
                         "marked down (reads degrade, writes defer)")
    ap.add_argument("--failpoints", default="",
                    help="arm fault-injection sites, e.g. "
                         "'wal.append.fsync=raise:28@nth:5'; same spec as "
                         "the MCQ_FAILPOINTS env var (DESIGN.md §12)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve Prometheus text + JSONL metrics over HTTP "
                         "on this port (0 = pick an ephemeral port, printed "
                         "at startup; -1 = off); arms telemetry")
    ap.add_argument("--metrics-dump", default="",
                    help="write a JSONL metrics image to this path on a "
                         "cadence (atomic replace); arms telemetry")
    ap.add_argument("--metrics-every", type=float, default=5.0,
                    help="seconds between --metrics-dump images")
    ap.add_argument("--incident-dir", default="",
                    help="flight-recorder incident dumps (last spans + "
                         "metric deltas on poison/strike-out/degraded "
                         "reads) land here as JSON; arms telemetry")
    ap.add_argument("--metrics-linger", type=float, default=0.0,
                    help="keep the metrics endpoint up this many seconds "
                         "after the run finishes (for scraping)")
    args = ap.parse_args(argv)
    if args.ranks is not None and args.num_shards <= 0:
        ap.error("--ranks serves the sharded chain: give --num-shards")
    if args.num_shards > 0:
        serve = (functools.partial(serve_ranks, args.num_shards, args.ranks)
                 if args.ranks is not None
                 else functools.partial(run_sharded, args.num_shards))
        serve(bucket_factor=args.bucket_factor, requests=args.requests,
              route_batch=args.route_batch, topn=args.topn,
              decay_threshold=args.decay_threshold,
              decay_block_rows=args.decay_block_rows,
              snapshot_dir=args.snapshot_dir,
              snapshot_every=args.snapshot_every,
              wal_dir=args.wal_dir, restore=args.restore,
              route_retry_budget=args.route_retry_budget,
              query_retry_budget=args.query_retry_budget,
              health_strikes=args.health_strikes,
              failpoints=args.failpoints,
              metrics_port=args.metrics_port,
              metrics_dump=args.metrics_dump,
              metrics_every=args.metrics_every,
              incident_dir=args.incident_dir,
              metrics_linger=args.metrics_linger,
              device=args.device)
        return
    run(args.arch, args.smoke, args.requests, args.prompt_len,
        args.new_tokens, args.draft_len,
        decay_threshold=args.decay_threshold,
        decay_block_rows=args.decay_block_rows, device=args.device)


if __name__ == "__main__":
    main()
