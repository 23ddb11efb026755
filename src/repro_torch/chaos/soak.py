"""Crash-soak harness (DESIGN.md §12) for the port: kill a serving worker
under load, recover, and prove the recovered state bit-exact.

Counterpart of ``tools/chaos/soak.py``, module for module and with the same
names, on the port's :class:`~repro_torch.serve.engine.ShardedEngine`.
One *life* = spawn a worker subprocess (``python -m repro_torch.chaos.soak
--worker``) that observes deterministic seeded batches through a durable
engine (WAL every batch, async snapshot cadence), then kill it — either an
external SIGKILL mid load, or a self-SIGKILL armed *inside* a persistence
failpoint via the port's ``MCQ_FAILPOINTS`` registry (``site=kill@nth:K``),
so deaths land mid-append, mid-fsync, mid-snapshot-write and
mid-manifest-commit, not just between steps.  After each death the
harness:

  1. recovers in-process (``restore()`` = newest complete snapshot + WAL
     replay), timing it;
  2. rebuilds an *oracle* engine with no persistence at all by replaying
     every durable step from an empty chain through the same ``observe()``
     pipeline, timed apart;
  3. asserts every leaf of the recovered published state equals the
     oracle's bit-for-bit, that the recovered WAL position equals the last
     durable record, and that a probe ``query`` and ``topn(8)`` agree.

Because a batch is WAL-appended strictly before it is applied and the apply
pipeline is replay-deterministic, snapshot+tail-replay and
full-replay-from-empty must converge to the identical state whatever
instant the process died at.  Any divergence — a torn record applied, a
record applied twice across a snapshot boundary, a half-published epoch
restored — fails the soak.

Workers run on the GPU unless ``--device cpu`` is given (no fallback: with
no GPU they fail as ``ShardedEngine(device=None)`` does).  The parent builds
the CUDA kernels once before the first worker starts, so every worker loads
the same library (``kernels/_build.py`` builds under a lock).  The kills are
process kills: the page cache survives them, so the soak cannot see a lost
fsync (``tests/test_torch_snapshot_commit.py`` holds the commit order).

  PYTHONPATH=src python -m repro_torch.chaos.soak --kills 8 --device cpu \\
      --junit chaos.xml --out faults.json

``--out`` writes the rows as JSON (nothing by default); ``--junit`` writes
one testcase per kill for CI.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional
from xml.sax.saxutils import escape

import numpy as np

REPO = str(Path(__file__).resolve().parents[3])

#: kill schedule, cycled per life: None = external SIGKILL at a jittered
#: step; otherwise the failpoint armed (via MCQ_FAILPOINTS) to SIGKILL the
#: worker from *inside* the persistence edge at a jittered hit count
KILL_MODES = (
    None,
    "wal.append.write",
    None,
    "wal.append.fsync",
    None,
    "snapshot.arrays_write",
    "wal.append.write",
    "snapshot.manifest_commit",
)

#: hard cap on steps per life — an armed failpoint the worker never
#: reaches (e.g. snapshot cadence not yet due) falls back to an external
#: kill instead of hanging the soak
MAX_STEPS_PER_LIFE = 40


def batch_for(seed: int, step: int, rows: int, batch: int):
    """The deterministic load stream: batch ``step`` is a pure function of
    (seed, step), so worker lives and the oracle generate identical data
    without sharing anything but the WAL (the reference's arrays)."""
    rng = np.random.default_rng([seed, step])
    src = rng.integers(0, rows, batch).astype(np.int32)
    dst = rng.integers(0, rows, batch).astype(np.int32)
    return src, dst


# ---------------------------------------------------------------------------
# engine plumbing (imported lazily: --help must not pay torch's import)
# ---------------------------------------------------------------------------


def _build_engine(workdir: Optional[str], rows: int, *,
                  snapshot_every: int = 0, device: str = "cuda"):
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    from repro_torch.serve.engine import ShardedEngine, ShardedServeConfig

    scfg = sh.ShardedConfig(base=mc.MCConfig(num_rows=rows, capacity=16,
                                             sort_passes=1),
                            num_shards=1, bucket_factor=2.0)
    cfg = ShardedServeConfig(
        sharded=scfg,
        snapshot_dir=os.path.join(workdir, "snap") if workdir else None,
        wal_dir=os.path.join(workdir, "wal") if workdir else None,
        wal_fsync="always",
        snapshot_every=snapshot_every,
        decay_threshold=1 << 30,   # no decay: lives stay comparable
    )
    # 'cuda' is the engine's default device: the GPU, an error without one
    return ShardedEngine(cfg, device=None if device == "cuda" else device)


def worker_main(args) -> None:
    """The killable serving loop: restore (or lay down the step-0 base
    snapshot), then observe deterministic batches forever, one WAL record
    per step, printing ``STEP <seq>`` after each durable+applied batch.
    ``BOOT`` reports the seconds the imports and the engine took (the CUDA
    context included on the GPU), ``RESTORED`` those of the restore."""
    t0 = time.perf_counter()
    eng = _build_engine(args.dir, args.rows,
                        snapshot_every=args.snapshot_every, device=args.device)
    print(f"BOOT engine_s={time.perf_counter() - t0:.6f}", flush=True)
    try:
        t0 = time.perf_counter()
        info = eng.restore()
        print(f"RESTORED step={info['step']} replayed={info['replayed']} "
              f"restore_s={time.perf_counter() - t0:.6f}", flush=True)
    except FileNotFoundError:
        eng.checkpoint()   # step-0 base: recovery always has a snapshot
    start = eng.wal.next_seq
    print(f"READY {start}", flush=True)
    step = start
    while True:
        src, dst = batch_for(args.seed, step, args.rows, args.batch)
        eng.observe(src, dst)
        print(f"STEP {step}", flush=True)
        step += 1
        if args.sleep:
            time.sleep(args.sleep)


# ---------------------------------------------------------------------------
# the soak loop (parent)
# ---------------------------------------------------------------------------


def _spawn_worker(workdir: str, rows: int, batch: int, seed: int,
                  snapshot_every: int, kill_site: Optional[str],
                  kill_hit: int, telemetry: bool = False,
                  poison: bool = False,
                  device: str = "cuda") -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    if telemetry:
        # arm the obs gate in the worker (spans, histograms, incidents) and
        # point the flight recorder's incident dumps at the workdir
        env["MCQ_METRICS"] = "1"
        env["MCQ_METRICS_INCIDENT_DIR"] = os.path.join(workdir, "incidents")
    else:
        env.pop("MCQ_METRICS", None)
        env.pop("MCQ_METRICS_INCIDENT_DIR", None)
    if kill_site is not None:
        # a poison life raises ENOSPC (persistent) instead of SIGKILLing:
        # the write path poisons, dumps a flight-recorder incident, and the
        # worker dies on the escalation — a diagnosable death, not a silent
        # one, exercising the incident pipeline under real load
        action = "raise:28" if poison else "kill"
        env["MCQ_FAILPOINTS"] = f"{kill_site}={action}@nth:{kill_hit}"
    else:
        env.pop("MCQ_FAILPOINTS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.chaos.soak", "--worker",
         "--dir", workdir, "--rows", str(rows), "--batch", str(batch),
         "--seed", str(seed), "--snapshot-every", str(snapshot_every),
         "--device", device],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)


def _run_life(proc: subprocess.Popen, kill_after_steps: int) -> dict:
    """Read worker progress until the kill moment (or the armed failpoint
    fires); returns what the parent observed about the life: its steps,
    whether a failpoint killed it, its exit code, and the seconds from the
    spawn to ``READY`` (``start_s``) with the worker's own ``engine_s``
    and ``restore_s`` inside them."""
    t0 = time.perf_counter()
    steps_seen = 0
    armed_death = False
    deadline_steps = kill_after_steps
    times = {"start_s": None, "engine_s": None, "restore_s": None}
    for line in proc.stdout:
        if line.startswith("STEP "):
            steps_seen += 1
            if steps_seen >= deadline_steps:
                break
        elif line.startswith("READY "):
            times["start_s"] = time.perf_counter() - t0
        elif line.startswith(("BOOT ", "RESTORED ")):
            for field in line.split()[1:]:
                key, _, value = field.partition("=")
                if key in times:
                    times[key] = float(value)
    else:
        armed_death = True   # stdout closed: the failpoint killed it
    if not armed_death:
        proc.send_signal(signal.SIGKILL)
    proc.wait()
    proc.stdout.close()
    return {"steps_seen": steps_seen, "armed_death": armed_death,
            "exit": proc.returncode, **times}


def _leaves(engine):
    """The engine's published state pinned: ``(snap, keys, leaves)``, the
    leaves in the checkpoint's order; the caller releases ``snap``."""
    from repro_torch.checkpoint import ckpt
    snap = engine.store.acquire()
    keys, leaves, _ = ckpt._paths_and_leaves(snap.state)
    return snap, keys, leaves


def _verify_recovery(workdir: str, rows: int, batch: int, seed: int,
                     device: str = "cuda"):
    """Recover, rebuild the oracle from the full deterministic history,
    and compare bit-exactly.

    The WAL alone is not the full history — committed snapshots GC the
    segments they cover — so the oracle replays ``batch_for(seed, 0..L)``
    from an empty chain through the same ``observe()`` pipeline, where
    ``L`` (the last durable step) is established independently of the
    recovered engine: the newest complete snapshot's ``wal_seq`` plus the
    WAL tail.  Each surviving WAL record is also checked against the
    deterministic stream, so a torn record that replay failed to reject
    is caught directly.

    Returns (recovery_seconds, last_seq, replayed, mismatches,
    oracle_seconds).
    """
    import torch

    from repro_torch.persist import snapshot as snapshot_io
    from repro_torch.persist.wal import WriteAheadLog

    t0 = time.perf_counter()
    eng = _build_engine(workdir, rows, device=device)
    info = eng.restore()
    recovery_s = time.perf_counter() - t0

    mismatches: List[str] = []
    snap_dir = os.path.join(workdir, "snap")
    step = snapshot_io.latest_complete_step(snap_dir)
    last = snapshot_io.load_meta(snap_dir, step)["wal_seq"] if step is not None else -1
    for seq, s, d, w in WriteAheadLog(os.path.join(workdir, "wal")).replay():
        last = max(last, seq)
        es, ed = batch_for(seed, seq, rows, batch)
        if not (np.array_equal(s, es) and np.array_equal(d, ed)
                and np.all(np.asarray(w) == 1)):
            mismatches.append(f"durable record {seq} does not match the "
                              f"deterministic stream (torn record "
                              f"survived replay)")
    if eng._seq != last:
        mismatches.append(
            f"wal position: recovered seq {eng._seq} != last durable "
            f"step {last}")

    t0 = time.perf_counter()
    oracle = _build_engine(None, rows, device=device)
    for i in range(last + 1):
        oracle.observe(*batch_for(seed, i, rows, batch))
    oracle_s = time.perf_counter() - t0
    durable = last + 1   # number of durable steps
    snap_r, keys, leaves_r = _leaves(eng)
    snap_o, _, leaves_o = _leaves(oracle)
    try:
        for key, lr, lo in zip(keys, leaves_r, leaves_o):
            if not torch.equal(lr, lo):
                mismatches.append(f"state leaf {key} diverged from the "
                                  f"WAL-replay oracle")
    finally:
        eng.store.release(snap_r)
        oracle.store.release(snap_o)

    # probe reads must agree too (the user-visible surface of the state)
    probe = np.arange(min(rows, 64), dtype=np.int32)
    for name, (a, b) in {
        "query": (eng.query(probe), oracle.query(probe)),
        "topn": (eng.topn(8), oracle.topn(8)),
    }.items():
        for xa, xb in zip(a, b):
            if not np.array_equal(_host(xa), _host(xb)):
                mismatches.append(f"{name} answers diverged")
                break
    eng.close()
    oracle.close()
    return recovery_s, durable, info["replayed"], mismatches, oracle_s


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _check_incidents(directory: str):
    """Every incident dump a poisoned worker left behind must parse and
    carry the flight-recorder payload (spans + metric deltas); returns
    ``(ok, message, count)``."""
    files = sorted(f for f in (os.listdir(directory)
                               if os.path.isdir(directory) else [])
                   if f.endswith(".json"))
    if not files:
        return False, "poison lives ran but no incident dump landed", 0
    bad = []
    for name in files:
        try:
            with open(os.path.join(directory, name)) as f:
                doc = json.load(f)
            if doc.get("schema") != "mcq-incident-v1":
                bad.append(f"{name}: wrong schema")
            elif not doc.get("spans"):
                bad.append(f"{name}: no spans")
            elif "deltas" not in doc or "reason" not in doc:
                bad.append(f"{name}: missing deltas/reason")
        except (OSError, json.JSONDecodeError) as e:
            bad.append(f"{name}: unparseable ({e})")
    if bad:
        return False, "; ".join(bad), len(files)
    return True, (f"{len(files)} incident dump(s), all parseable with "
                  f"spans + deltas"), len(files)


def run_soak(kills: int, *, rows: int = 256, batch: int = 128, seed: int = 0,
             snapshot_every: int = 5, min_steps: int = 3,
             max_steps: int = 12, workdir: Optional[str] = None,
             telemetry: bool = False, device: str = "cuda") -> dict:
    """Run the kill/recover/verify loop; returns rows plus an ok flag
    (every life recovered bit-exactly).  ``telemetry=True`` arms the obs
    gate in every worker and turns ``wal.append.write`` lives into
    poison-raise lives, so the soak also proves a killed-under-load run
    leaves a parseable flight-recorder incident dump behind.  ``device``:
    where the workers and the verification run (``'cuda'``: the GPU)."""
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.load()   # build once here, not in every worker
    owns_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="mcq-chaos-")
    rng = np.random.default_rng(seed)
    rows_out, all_ok = [], True
    recoveries = []
    n_poison = 0
    try:
        for k in range(kills):
            site = KILL_MODES[k % len(KILL_MODES)]
            kill_hit = int(rng.integers(1, 8))
            kill_after = int(rng.integers(min_steps, max_steps + 1))
            if site is not None:
                kill_after = MAX_STEPS_PER_LIFE   # fallback external kill
            poison = telemetry and site == "wal.append.write"
            n_poison += int(poison)
            proc = _spawn_worker(workdir, rows, batch, seed,
                                 snapshot_every, site, kill_hit,
                                 telemetry=telemetry, poison=poison,
                                 device=device)
            life = _run_life(proc, kill_after)
            t_rec, durable, replayed, bad, t_oracle = _verify_recovery(
                workdir, rows, batch, seed, device=device)
            ok = not bad
            all_ok &= ok
            recoveries.append(t_rec)
            mode = site or "sigkill"
            rows_out.append({
                "name": f"B9_crash_soak[kill={k};mode={mode}]",
                "us_per_call": round(t_rec * 1e6, 1),
                "derived": (f"recovered {durable} records "
                            f"(replayed {replayed}) "
                            f"{'bit-exact' if ok else 'DIVERGED: ' + '; '.join(bad)}"),
                "kill_mode": mode, "steps": durable,
                "replayed": replayed, "bitexact": ok,
                "oracle_s": t_oracle, **life,
            })
            print(f"kill {k}: mode={mode} durable={durable} "
                  f"replayed={replayed} recovery={t_rec * 1e3:.1f} ms "
                  f"oracle={t_oracle * 1e3:.1f} ms "
                  f"{'ok' if ok else 'DIVERGED'}", flush=True)
            if not ok:
                break   # state is wrong: every later life would be too
        if telemetry and n_poison:
            inc_ok, inc_msg, n_inc = _check_incidents(
                os.path.join(workdir, "incidents"))
            all_ok &= inc_ok
            rows_out.append({
                "name": "B9_telemetry_incidents",
                "us_per_call": 0.0,
                "derived": inc_msg,
                "incidents": n_inc, "parseable": inc_ok,
            })
            print(f"incidents: {inc_msg}", flush=True)
        if recoveries:
            rows_out.append({
                "name": "B9_recovery_summary",
                "us_per_call": round(float(np.mean(recoveries)) * 1e6, 1),
                "derived": (f"{len(recoveries)} kills, max recovery "
                            f"{max(recoveries) * 1e3:.1f} ms, "
                            f"all bit-exact={all_ok}"),
                "kills": len(recoveries),
                "mean_recovery_us": round(float(np.mean(recoveries)) * 1e6, 1),
                "max_recovery_us": round(float(np.max(recoveries)) * 1e6, 1),
                "bitexact": all_ok,
            })
    finally:
        if owns_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    return {"rows": rows_out, "ok": all_ok}


def write_junit(result: dict, path: str) -> None:
    cases = []
    for row in result["rows"]:
        body = ""
        if not row.get("bitexact", True):
            body = (f'<failure message="divergence">'
                    f'{escape(row["derived"])}</failure>')
        cases.append(f'<testcase classname="chaos" '
                     f'name="{escape(row["name"])}" '
                     f'time="{row["us_per_call"] / 1e6:.3f}">{body}'
                     f"</testcase>")
    fails = sum(1 for c in cases if "<failure" in c)
    xml = ('<?xml version="1.0" encoding="utf-8"?>\n'
           f'<testsuite name="chaos-soak" tests="{len(cases)}" '
           f'failures="{fails}">' + "".join(cases) + "</testsuite>\n")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(xml)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos.soak", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kills", type=int, default=20)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snapshot-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="where the workers serve: cuda (the GPU) or cpu")
    ap.add_argument("--sleep", type=float, default=0.0,
                    help="worker inter-step sleep (worker mode)")
    ap.add_argument("--dir", default=None,
                    help="persist under this directory instead of a "
                         "temp dir (worker mode: required)")
    ap.add_argument("--out", default="",
                    help="write the rows as JSON to this path ('' to skip)")
    ap.add_argument("--junit", default=None, metavar="FILE")
    ap.add_argument("--telemetry", action="store_true",
                    help="arm the obs gate in every worker and verify "
                         "poisoned lives leave parseable flight-recorder "
                         "incident dumps (DESIGN.md §13)")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker:
        if not args.dir:
            ap.error("--worker requires --dir")
        worker_main(args)
        return 0

    result = run_soak(args.kills, rows=args.rows, batch=args.batch,
                      seed=args.seed, snapshot_every=args.snapshot_every,
                      workdir=args.dir, telemetry=args.telemetry,
                      device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"bench": "faults", "rows": result["rows"]}, f,
                      indent=1)
        print(f"wrote {args.out}")
    if args.junit:
        write_junit(result, args.junit)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
