#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as below
    python3 chip_smoke.py --phases device,kernels   # a subset, for debugging
    python3 chip_smoke.py --phases device,kernels,hash   # the dst-hash path
    python3 chip_smoke.py --phases device,kernels,sharded   # the sharded chain
    python3 chip_smoke.py --phases device,ranks   # the chain and the
                                                  # engine one shard a
                                                  # process rank
    python3 chip_smoke.py --phases device,persist   # durability (runs phase
                                                    # sharded's warm-up first)
    python3 chip_smoke.py --phases device,engine    # the serving engine (the
                                                    # same warm-up first)
    python3 chip_smoke.py --phases device,soak,examples   # the crash soak
                                                    # and the chain examples

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` from source, then

  1. device   — card name and power limit, torch/CUDA versions, build time;
                ``python -m repro_torch.launch.dryrun`` for
                ``qwen2-7b/decode_32k`` and ``mamba2-130m/train_4k`` (meta
                tensors: bytes by part, whether they fit one card, counted
                FLOPs beside ``model_flops``, H100 roofline terms), their
                JSON printed;
  2. kernels  — every kernel against its plain PyTorch version ON the card at
                small odd shapes (ragged batches, padding rows, saturated
                tables, duplicates, unknown srcs, ``max_items > C``, threshold
                and top-k mode, rows wider than the fused read's step, rows
                that are not 16 B aligned), the decay at C from 1 to 256
                (tied, all-zero and all-evicted rows, the rolling form with
                the clamped last block and a cursor past it), and the
                new-edge pass where its rows and its
                sort are stressed (8,192 items on 4 rows and on 8,192 rows,
                rows running out mid-pass, 65,536 mostly inactive items,
                30,000 items with rows sorted in tiles and merged, the
                functional / in-place contract); every in-place form (the
                row flags it sets included) and copy_dirty_rows; the
                cross-shard merge at S 1-32, M 1-300, n 1 to min(S·M+3,
                400) and at 33-1,100 lists (ties, dead tails, lists not descending, NaN
                heads); the top-n's window kernel (block lists, counts and
                the whole read) at S 1-40, N 1 to 1,000, C 1 to 1,024, n 1
                to 300, tied, sparse, empty, src tables with lanes past the
                rows, and 4 B off a 16 B boundary; outputs
                must be EQUAL (tolerance 0, integers and float32 alike);
                the LM launcher's and the engine launcher's processes run
                beside these checks (phases lm and engine check them);
  3. main     — the main path at full width: a chain of 2**20 source rows x 128
                slots, warmed by streaming ``update_batch_`` calls of 65,536
                transitions; the owner calls held equal to the functional
                calls on a side copy for a few rounds; then rounds of
                ``update_batch_`` + threshold query + top-k query +
                ``maybe_decay_``, with launch counts read around the rounds
                and no device->host synchronisation allowed inside any of
                them nor one rolling ``decay_``, and a profiler check that
                an owner update and a rolling ``decay_`` copy no state; then
                the same queries
                through the unfused read (``fused_query=False``), equal to
                the fused answers, with its own launch counts; then each
                kernel at the shapes and data that path gave it, against its
                plain version (equal) and timed beside its bound (the
                new-edge pass also without its copies, and by launch; the
                probe at the update's and the queries' keys, beside the
                launch floor and its dependent round trips; the in-place
                forms as the owner calls launch them and the functional
                wrappers, copies included, beside them; the decay also
                alone on a block and on the whole table, beside torch.sort;
                device kernels per ``lookup_rows``, ``decay_sort`` and fused
                query call counted by torch.profiler);
  4. hash     — the main path with the per-row dst hash (paper §II.2,
                ``use_dst_hash=True``, 512 lanes per row): the same chain and
                traffic, the warm-up with ``maybe_decay_``; the owner calls
                held equal to the functional ones on a side copy, rounds
                under the same launch-count and no-sync checks, the
                profiler's no-copy check; the back-buffer learner over it;
                an update's device time, hash against scan on the same
                batches; a rebuild of the warmed table forced inside
                ``decay_`` (decided on the device), then every invariant,
                ``dst_hash_consistent`` included; then the path's device
                code at its shapes against its plain versions and timed
                beside its bounds (the stacked probe beside the scan, the
                new-edge pass with the row-hash edits, the rolling decay
                with the repair beside it without, the rebuild, the
                learner's catch-up with row hashes);
  5. drafter  — the speculative drafter at full width: a chain of 2**20
                contexts x 64 slots behind an ``EpochStore``, a learner loop
                through the back buffer (``BackBufferLearner.write``:
                copy_dirty_rows, observe_ 64 x 1,025 tokens, maintain_,
                publish), its first states held equal to a functional
                learner's, and a reader loop (acquire -> draft 4,096 windows
                at k=4 and k=8 -> candidates -> release), tokens from a
                152,064-token vocabulary; launch counts around the rounds;
                a profiler check that a learner write copies no state; the
                decaying learner step and the candidates equal to the plain
                versions',
                ``draft`` equal to ``draft_reference``; then every kernel of
                the path at the shapes and data it gave them, against its
                plain version (equal) and timed beside its bound, the draft
                walk also inside the learner loop;
  5b. lm     — the LM serving path (``serve.engine.Engine`` with the
                MCPrioQ drafter) at full width for ``qwen2-7b`` (dense),
                ``deepseek-moe-16b`` (MoE, 65.5 GB), ``mamba2-130m`` (SSM)
                and ``recurrentgemma-9b`` (RG-LRU + local attention):
                ``python -m repro_torch.launch.serve --arch
                mamba2-130m`` as a user runs it (2 requests); then per
                arch random float32 parameters made on the card from a
                seeded generator, bfloat16 compute, the reference
                launcher's sizes (drafter 8,192 x 64, draft_len 4); 3
                requests of 2 x 64 prompt tokens and 24 new tokens served
                with plain greedy decoding and then with speculation (the
                arch's launch window), the tokens equal; a 4-token
                extension's logits and caches equal to 4 decode steps';
                prefill, decode and extension ms, tokens/s, model calls,
                acceptance, learner and draft ms, device memory before the
                init and the peak over the serves; the drafter's published
                chain equal to the learned histories replayed through the
                plain versions on the card, a draft equal to its plain
                version; the model at full width and a depth of 2 (3 for
                recurrentgemma: one whole period) on the card against the
                CPU in float32 and bfloat16 (the largest and the mean
                logit difference within stated bounds, the card's own
                bfloat16 rounding at most 4x the CPU's, greedy tokens equal
                where the top-2 margin is clear, at one position at
                least); the drafter's kernels at
                the path's shapes, tagged ``[lm]``, their launches summed
                over the archs (each arch's in ``launches_by_arch``); then
                ``whisper-base`` (stub frames [2, 1500, 512]) and
                ``phi-3-vision-4.2b`` (16.6 GB, stub patch embeddings [2,
                256, 3072]), which no ``Engine`` serves, through ``Model``:
                a prefill, 32 greedy decodes, latencies, peak memory, a
                4-token extension == 4 decodes bit for bit (the encoder's
                projected memory untouched), and the model at depth 2 on
                the card against the CPU under the same rule (whisper's
                ``wq``/``wk`` divided by 8 there, so its attention scores
                no longer amplify rounding); per served arch the decode
                step's roofline (``launch/roofline.py``): its memory
                floor's time at the phase's batch and context beside its
                device time (torch.profiler) and latency, with the shares;
  5c. train   — the training path: ``python -m repro_torch.launch.train``
                on ``mamba2-130m`` at full width with the reference
                launcher's defaults (batch 8 x 128), 12 steps in one process
                and, at the same time, a run to step 6 that checkpoints
                there, then a second process that resumes it to step 12:
                the two final checkpoints equal leaf for leaf, bit for bit;
                ``whisper-base`` through ``make_train_step`` at full width
                (frames [4, 1500, 512], 128 tokens, 2 microbatches, int8
                compression): losses, s/step, a microbatch's gradients twice
                equal, its int8 codes, scales and residual == the CPU's on
                the same gradients; no hand-written kernel launched; the
                depth-2 float32 gradients and loss card vs CPU, each leaf
                within 2e-3 of its largest, on ``mamba2-130m`` (batch 8 x
                128) and on ``whisper-base`` (wq/wk divided by 8); the
                launcher's mfu (``model_flops`` of a step over 989 TFLOP/s
                against its s/step);
  6. sharded  — the sharded chain at full width: 4 logical shards of phase
                main's chain stacked on the card (4 x 2**20 rows x 128
                slots), 4 x 65,536 transitions per update routed through
                buckets of twice the fair share, 4 x 4,096 query srcs, the
                global top-16; warmed by ``update_`` over 1/8 of phase
                main's warm-up batches (a cut of depth that keeps the script
                inside its time); the owner calls held
                equal to the functional callables on a side copy; rounds of
                ``update_`` + query + ``maintain_`` + ``topn`` with launch
                counts around them and no device->host synchronisation in
                any; the profiler's no-copy check on ``update_`` and
                ``maintain_``; a skewed round whose ``route_dropped``
                equals ``predict_route_overflow``; the top-16 against a
                stable sort of every shard's live edges on the host; then
                shard 0's kernels at the shapes the routing gives them; the
                top-16's window kernel and the merge of its block lists
                against their plain mirrors beside their bounds, the launch
                floor, ``torch.topk`` / ``torch.sort`` and the plain
                path's sort; a profiler check that ``sh.topn``
                runs no sort and no op over the ``[S, N, k]`` windows;
  6a. ranks   — the sharded chain one shard a process rank
                (``sharding/ranks.py``, ``core/sharded.py``'s ``ranks=``
                forms), the ranks spawned after the kernels are built here,
                each group joined within 180 s or killed, naming the rank:
                (a) one NCCL rank (world 1, S = 1, phase main's chain)
                beside the one-card chain at S = 1 on the same card, 20
                rounds of ``update_`` + query + ``maintain_`` + top-16
                after one unguarded, every leaf, answer and top-16 equal,
                the rank's calls under ``set_sync_debug_mode('error')``;
                (b) 4 gloo ranks sharing the one card (host-staged through
                pinned memory), each 2**20 x 128, phase sharded's traffic
                (each rank its slice of every global batch), 32 warm-up
                and 20 timed rounds (each rank's medians by events and the
                collectives' share by events around them), a skewed round,
                then ``gather_sharded`` to rank 0, which replays the same
                batches through the one-card stacked chain: the stacked
                leaves, every rank's queries and top-16s, ``counter_stats``
                over the group and each rank's ``route_dropped`` (==
                ``predict_route_overflow``) equal; (c) where the machine has
                two cards or more, (b) over NCCL at world min(4, cards),
                rank r on cuda:r, else one line says it was not run; then
                each group serves through ``ShardedEngine(cfg,
                ranks=group)`` at that width: two reader lanes (16,384-src
                queries, top-16s) reading while 20 observes of world x
                65,536 transitions run, an async checkpoint after 10, a
                crash and a fresh engine's restore with WAL replay, and at
                2^16 rows a shard a reassign and an elastic restore onto
                half the ranks; every rank's answers equal, rank 0 holding
                each lane read to an engine-free oracle at the versions its
                ranks pinned, the recovered state and counters to the
                oracle, the small runs to the one-card engine; each rank's
                observe and lane p50/p99 (the collectives' share), restore,
                replay and reassign times printed beside the card;
  6b. engine  — the serving engine (``serve.engine.ShardedEngine``) at
                phase sharded's width: the launcher ``python -m
                repro_torch.launch.serve --num-shards 4`` run twice, the
                second time with ``--restore``, then with ``--ranks gloo``
                (4 rank processes on the card); phase sharded's final state
                snapshotted and restored into the engine; 20 observes of
                262,144 transitions (WAL, back-buffer writes, ``maintain_``
                decaying) while a query reader (16,384 srcs) and a top-16
                reader loop in threads, launch counts around them, a
                checkpoint(sync=False) after round 10; every stacked leaf,
                the device counters and a query and top-16 equal to an
                engine-free oracle (the same batches through ``sh.update_``
                + ``sh.maintain_`` on a private copy); a crash, a fresh
                engine, restore + WAL replay equal to the uninterrupted
                state; observes with no reader and the reads' device time;
                the stacked catch-up as ``copy_dirty_rows[engine]``; a
                transient ``engine.publish`` fault retried and a persistent
                ``engine.apply`` fault poisoning the writes (reads serve the
                last epoch) healed by ``restore()``, each equal to the
                oracle; a live ``reassign`` onto a rotated map with a
                reader running, edges conserved up to ``dropped_probes``,
                the top-16 kept;
  7. persist  — durability on the card.  Phase main's chain, warmed over
                half phase main's batches (a cut of depth), is
                snapshotted (sync), then 20 rounds log each batch to a WAL
                before ``update_batch_`` + ``maybe_decay_`` (the decay fires,
                a quarter of every fourth batch goes to new successors so new
                pairs are deferred), with ``save_snapshot_async`` after round
                10 while the later rounds write; then a "crash": the newest
                complete snapshot restored into a fresh chain on the card and
                the later records replayed through the same owner calls — all
                18 leaves and ``counter_stats`` equal to the uninterrupted
                chain's; the same snapshot restored on the CPU equal to the
                card's; the replay's device busy share (torch.profiler);
                appends under each fsync policy.  Then phase sharded's final
                state (4 x 2**20 x 128; its warm-up alone when phase sharded
                does not run) snapshotted, restored and resharded onto 2
                shards of 2**21 rows: ``extract_edges`` on the card,
                ``owner_of``, ``plan_batches`` (slices of 65,536), the routed
                update with the new-edge bound lifted, ``settle_order_`` —
                no routing drop, the edges conserved up to the counted
                ``dropped_probes`` (whole srcs), each surviving src's ``tot``
                unchanged, no inversion, every shard's invariants;
  8. monitor  — the expert monitor at deepseek-moe-16b's routing widths
                (28 layers x 64 experts, 6 per token): 20 steps of router
                histograms over 4,096 tokens per layer, some layers
                collapsed; every leaf, ``balance_report`` and
                ``hot_experts`` equal to the same monitor's on the CPU
                (plain versions); ms per ``observe`` and per report;
  8b. soak    — the port's kill-and-recover soak (``repro_torch.chaos.soak``)
                at half phase main's width (cut from 2**20 rows to keep the
                script inside its time): 2**19 rows x 16 slots (the soak's
                capacity), batches of 65,536, a snapshot every 5 observes,
                every batch WAL-logged with fsync; 8 worker processes on the
                card, one cycle of its kill modes (3 external SIGKILLs, and
                self-kills inside ``wal.append.write`` (twice),
                ``wal.append.fsync``, ``snapshot.arrays_write`` and
                ``snapshot.manifest_commit``, each of which must die by its
                failpoint); after each death a recovery
                here on the card, every leaf, the WAL position and a probe
                query and top-8 held bit for bit against an oracle that
                replays every durable batch; each kill's records, replay
                and recovery ms, the oracle's replay and the worker's
                start-up; the last snapshot restored on the card and on the
                CPU, equal; the path's kernels at the soak's shapes against
                their plain versions, tagged ``[soak]``;
  8c. examples — ``examples/torch_{telecom_paging,recommender_sessions,
                quickstart,lm_speculative_serve}.py`` as a user runs them,
                on the card and with ``--device cpu``, all eight at once:
                each exits 0 and prints the same lines on both (timings and
                a process id masked; the LM example's losses, rates,
                acceptance and model calls too); the LM example's model
                calls on the card at most plain greedy's, its step-10 loss
                within a bound from the CPU's own bfloat16 rounding;
  9. parity   — the whole path at a small configuration (16 batches, 32
                with the dst hash, 8 on the sharded path and the reshard),
                once with the CUDA
                kernels and once with the plain versions, every state leaf and
                every query answer equal after every batch, the owner calls
                and their row flags too; the same with the dst hash (rebuilds
                firing) and through the back-buffer learner on it; the same
                for the unfused read and for a small drafter stream, drafts
                included; and the sharded path at S = 4 (owner calls with
                their row flags, functional callables, routed answers and
                drops, the top-n), and a small reshard, 4 -> 2 and 4 -> 8,
                every stacked leaf equal after the unbounded ingest and the
                settle; and the engine script at S = 4 (observe, reads, a
                retried and a poisoning fault healed, a down shard healed,
                a crash and restore, reassign, an elastic restore 4 -> 2),
                every stacked leaf, answer and stats counter equal; engines
                of 40 shards (kernels and plain versions: every stacked
                leaf, answer and top-16 equal, the top-16 equal to a host
                sort), their catch-up over 400 scalars as
                ``copy_dirty_rows[S=40]``, the merge at 33, 40 and 64 lists
                (one launch each) against the flat plain version and the
                mirror of its launches,
                a 64-shard top-16 against a host sort, the merges at the
                engine's and the 64-shard chain's lists as
                ``topn_merge[S=40]`` and ``topn_merge[S=64]``.

Cuts of depth that keep the script inside its time: the drafter's warm-up
is a quarter of ``--warm-batches``, phase persist's chain half, phase
sharded's 1/8; phase lm serves 3 requests an arch and runs the launcher on
``mamba2-130m``; phase train's launcher runs 12 steps, stopped at 6; phase
parity's sharded
chain and reshard run 6 batches; the
reshard's new-edge check takes 1/8 of each sender's slice.

Any failing phase raises and the script exits non-zero; without a CUDA device
it exits non-zero at once.  The last line of standard output is
``{"ok": true, "device": {...}}``, the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import dataclasses
import gc
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12         # non-tensor-core 32-bit rate (data sheet, fp32)
PHASES = ("device", "kernels", "main", "hash", "drafter", "lm", "train",
          "sharded", "ranks", "engine", "persist", "monitor", "soak",
          "examples", "parity")


def say(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def time_ms(fn, reps=10, warm=2, flush=None):
    """Median milliseconds of ``fn()`` by CUDA events, after ``warm`` calls.
    ``flush`` (a large tensor) is rewritten before each timed call so the
    call finds the L2 cache cold, as it would inside the main path."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_ms(fn, reps=20, busy_cycles=4_000_000):
    """Two medians of ``fn()`` by CUDA events, in turns: ``device`` — a spin
    kernel (~2 ms) is queued first, so the host has launched the whole call
    before the device reaches it and the events see device time only;
    ``idle`` — on an idle device, so the events also see the host's launch
    time: the latency a caller waits."""
    device, idle = [], []
    for _ in range(reps):
        for busy, out in ((True, device), (False, idle)):
            torch.cuda.synchronize()
            if busy:
                torch.cuda._sleep(busy_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(device), statistics.median(idle)


def call_restored(fn, restore, flush, reps=20, busy_cycles=4_000_000):
    """``call_ms`` for a call that writes into its inputs: the medians of
    ``fn()``'s device time (a spin kernel queued ahead) and of its latency
    on an idle device, in turns, each call after ``restore()`` and a
    rewrite of ``flush`` (neither timed)."""
    device, idle = [], []
    for _ in range(reps):
        for busy, out in ((True, device), (False, idle)):
            restore()
            flush.add_(1)
            torch.cuda.synchronize()
            if busy:
                torch.cuda._sleep(busy_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(device), statistics.median(idle)


def split_ms(fn, restore, flush):
    """``{"device_ms", "latency_ms"}`` of ``fn()`` (``call_restored``)."""
    device, idle = call_restored(fn, restore, flush)
    return {"device_ms": device, "latency_ms": idle}


def flat(outputs):
    return list(outputs) if isinstance(outputs, (tuple, list)) else [outputs]


def compare(name, got, want):
    """All outputs equal (torch.equal); returns the largest |difference|."""
    got, want = flat(got), flat(want)
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs vs {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.bool or w.dtype == torch.bool:
            g, w = g.to(torch.int32), w.to(torch.int32)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(
                f"{name}: output {i}: {g.dtype}{tuple(g.shape)} vs "
                f"{w.dtype}{tuple(w.shape)}")
        if g.numel():
            worst = max(worst, float((g.double() - w.double()).abs().max()))
        if not torch.equal(g, w):
            bad = torch.nonzero(g != w)[0].tolist()
            raise AssertionError(
                f"{name}: output {i} differs from the plain version, first at "
                f"{bad}: kernel {g[tuple(bad)].item()} vs plain "
                f"{w[tuple(bad)].item()} (max |diff| {worst})")
    return worst


def randint(gen, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def random_slabs(gen, n, c, density=0.6, hi=1000):
    live = torch.rand((n, c), generator=gen, device="cuda") < density
    cnt = torch.where(live, randint(gen, 1, hi, (n, c)), 0).to(torch.int32)
    dst = torch.where(live, randint(gen, 0, 10_000, (n, c)), -1).to(torch.int32)
    tot = cnt.sum(dim=1).to(torch.int32)
    order = torch.sort(-cnt, dim=1, stable=True).indices.to(torch.int32)
    return dst, cnt, tot, order


def random_perm_rows(gen, n, c):
    return torch.argsort(torch.rand((n, c), generator=gen, device="cuda"),
                         dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# phase 1: device + build
# ---------------------------------------------------------------------------


#: cells of ``python -m repro_torch.launch.dryrun`` in phase device (the
#: whole grid, ``--all``, is not run here)
DRYRUN_CELLS = (("qwen2-7b", "decode_32k"), ("mamba2-130m", "train_4k"))


def dryrun_cells():
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_CELLS as a
    user runs it, all at once on the host (meta tensors: no device, no
    memory); returns a function that waits for them, prints each cell's
    JSON and checks it (called after phase kernels, which the two
    processes overlap on the host)."""
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), OMP_NUM_THREADS="1")
    procs = [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0],
         "--shape", cell[1]], cwd=repo, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for cell in DRYRUN_CELLS]
    t0 = time.perf_counter()

    def finish():
        for (arch, shape), proc in procs:
            try:
                out, err = proc.communicate(timeout=600)
            finally:
                proc.kill()
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if proc.returncode != 0 or len(lines) != 1:
                raise AssertionError(f"dryrun {arch}/{shape} exited "
                                     f"{proc.returncode}: {out[-2000:]} "
                                     f"{err[-2000:]}")
            res = json.loads(lines[0])
            if res["status"] != "ok" or not res["counted_flops"] > 0:
                raise AssertionError(f"dryrun {arch}/{shape}: {res}")
            say(f"[device] dryrun {arch}/{shape} (meta device, "
                f"{time.perf_counter() - t0:.1f} s after the start): "
                f"{lines[0]}")
    return finish


BASELINE_SOURCE = Path(__file__).resolve().parent / "scripts" / "baseline_kernels.cu"
_baseline = {}


def start_baseline_build():
    """Start ``nvcc`` on ``scripts/baseline_kernels.cu`` (the odd-even
    kernel and the catch-up the redesigns replaced) beside the package's
    build; ``baseline_lib`` waits for it."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "baseline" / "libmcq_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    _baseline.update(path=out, proc=subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), "-o", str(out), str(BASELINE_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))


def baseline_lib():
    """The yardstick kernels' library (``mcq_base_oddeven``,
    ``mcq_base_copy_dirty_rows``), built by ``start_baseline_build``."""
    if "lib" not in _baseline:
        out, _ = _baseline["proc"].communicate()
        if _baseline["proc"].returncode != 0:
            raise RuntimeError(f"nvcc failed on {BASELINE_SOURCE}:\n{out}")
        lib = ctypes.CDLL(str(_baseline["path"]))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mcq_base_oddeven.argtypes = [p, p, p, p, ll, i, i, p]
        lib.mcq_base_copy_dirty_rows.argtypes = [p] * 19 + [ll, i, ll, i, i, p]
        for fn in (lib.mcq_base_oddeven, lib.mcq_base_copy_dirty_rows):
            fn.restype = ctypes.c_int
        _baseline["lib"] = lib
    return _baseline["lib"]


def baseline_call(name, *args):
    """Launch a yardstick kernel on the current stream; raise on an error."""
    status = getattr(baseline_lib(), name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def old_oddeven(cnt, order, order_out, passes, dirty=None):
    """The odd-even kernel the redesign replaced (one warp a row), into
    ``order_out`` (a fresh tensor, returned, when None)."""
    out = torch.empty_like(order) if order_out is None else order_out
    baseline_call("mcq_base_oddeven", cnt.data_ptr(), order.data_ptr(),
                  out.data_ptr(), None if dirty is None else dirty.data_ptr(),
                  cnt.shape[0], cnt.shape[1], passes)
    return out


def phase_device():
    from repro_torch.kernels import _build
    start_baseline_build()
    dryrun_done = dryrun_cells()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}"
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"capability {torch.cuda.get_device_capability(0)}")
    _build.load()
    if _build.build_seconds is None:
        say(f"[device] kernels: loaded an existing build of these sources "
            f"from {_build.BUILD_DIR}")
    else:
        say(f"[device] kernels built in {_build.build_seconds:.1f} s "
            f"({len(_build.sources()[0])} sources, one nvcc each, into "
            f"{_build.BUILD_DIR})")
        for line in ptxas_summary(_build.build_log):
            say("[device]   " + line)
    return card, dryrun_done


def ptxas_summary(log):
    """One line per compiled kernel from ``-Xptxas -v``: its (mangled)
    name, spills and registers; errors as they are."""
    out, name, spills = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spills}")
        elif "error" in line:
            out.append(line.strip())
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at small odd shapes
# ---------------------------------------------------------------------------


def build_tables(gen, n, h, max_probes, fill, delete_frac):
    """A stack of N open-addressing tables with real chains (built by the
    plain sequential insert), with a share of the keys tombstoned."""
    from repro_torch.core import hashtable as ht
    keys = torch.full((n, h), -1, dtype=torch.int32, device="cuda")
    vals = torch.full((n, h), -1, dtype=torch.int32, device="cuda")
    for r in range(n):
        ks = torch.randperm(500, generator=gen, device="cuda")[:fill].to(torch.int32)
        tab = ht.make(h, device="cuda")
        tab, _, _ = ht.insert_batch_sequential(
            tab, ks, torch.arange(fill, device="cuda"),
            torch.ones(fill, dtype=torch.bool, device="cuda"), max_probes)
        dead = torch.rand(fill, generator=gen, device="cuda") < delete_frac
        for k in ks[dead].tolist():
            tab, _ = ht.delete(tab, k, max_probes)
        keys[r], vals[r] = tab.keys, tab.vals
    return keys, vals


def small_kernel_checks(gen):
    from repro_torch.kernels import ops
    checked = 0

    def both(name, fn, *args, **kw):
        nonlocal checked
        got = fn(*args, impl="cuda", **kw)
        torch.cuda.synchronize()
        compare(name, got, fn(*args, impl="ref", **kw))
        checked += 1
        return got

    def both_(name, fn, written, *args, written_kw=(), **kw):
        """An in-place form, kernel and plain version each on copies of the
        arguments it writes (their positions in ``written``, and the
        keyword arguments named in ``written_kw``) and with dirty flags
        (some set before, which stay set): the written tensors and the
        flags equal."""
        nonlocal checked
        outs = []
        rows = next(args[i].shape[0] for i in written if args[i].dim() == 2)
        for impl in ("cuda", "ref"):
            a = [x.clone() if i in written else x for i, x in enumerate(args)]
            k = {key: x.clone() if key in written_kw else x
                 for key, x in kw.items()}
            dirty = torch.zeros(rows, dtype=torch.uint8, device="cuda")
            dirty[::5] = 1
            fn(*a, dirty=dirty, impl=impl, **k)
            outs.append([a[i] for i in written]
                        + [k[key] for key in written_kw] + [dirty])
        torch.cuda.synchronize()
        compare(name + " (in place, flags)", *outs)
        checked += 1
        return outs[0]

    for c in (1, 5, 32, 64, 96, 128, 256, 300):
        n = 37
        dst, cnt, tot, order = random_slabs(gen, n, c)
        # oddeven: random permutations, ties, several pass counts
        small = torch.where(cnt > 0, cnt % 4, 0).to(torch.int32)
        perm = random_perm_rows(gen, n, c)
        for passes in (0, 1, 2, c // 2 + 1):
            both(f"oddeven C={c} passes={passes}", ops.oddeven_sort, small, perm,
                 passes=passes)
            both_(f"oddeven C={c} passes={passes}", ops.oddeven_sort_, (1,),
                  small, perm, passes=passes)
        both(f"decay_sort C={c}", ops.decay_sort, cnt, dst, perm)
        # slab_update: ragged batch, padding rows, absent edges, duplicates
        for batch in (0, 1, 77):
            rows = randint(gen, -1, n, (batch,))
            pick = randint(gen, 0, c, (batch,)).long()
            dsts = dst[rows.clamp(min=0).long(), pick]
            absent = torch.rand(batch, generator=gen, device="cuda") < 0.25
            dsts = torch.where(absent, 54321, dsts).to(torch.int32)
            if batch > 8:
                rows[:4], dsts[:4] = rows[4:8].clone(), dsts[4:8].clone()
            w = randint(gen, 1, 9, (batch,))
            dup = dst.clone()
            dup[0] = torch.where(cnt[0] > 0, 77, -1)   # repeated dst: first slot
            both(f"slab_update C={c} B={batch}", ops.slab_update, rows, dsts, w,
                 dup, cnt, tot)
            both_(f"slab_update C={c} B={batch}", ops.slab_update_, (4, 5),
                  rows, dsts, w, dup, cnt, tot)
        # cdf: thresholds, top-k, unknown srcs, empty row, max_items > C
        cnt2, dst2, tot2 = cnt.clone(), dst.clone(), tot.clone()
        cnt2[1], dst2[1], tot2[1] = 0, -1, 0
        for batch in (1, 45):
            rows = randint(gen, 0, n, (batch,))
            found = torch.rand(batch, generator=gen, device="cuda") < 0.8
            rows = torch.where(found, rows, 0).to(torch.int32)
            for max_items in (1, 16, c + 3):
                for t in (0.0, 0.5, 0.9, 1.0, None):
                    both(f"cdf C={c} B={batch} k={max_items} t={t}",
                         ops.cdf_query_fused, rows, found, cnt2, dst2, order,
                         tot2, t, max_items=max_items)
        # the same rows 4 B past a 16 B boundary: the read's scalar loads
        skew = [misaligned(x) for x in (cnt2, dst2, order)]
        for t in (0.5, None):
            both(f"cdf C={c} B=45 misaligned rows t={t}", ops.cdf_query_fused,
                 rows, found, *skew, tot2, t, max_items=c + 3)
        # cdf over pre-ordered rows, as _ordered_rows gathers them: unknown
        # srcs zeroed, a known all-zero row, ragged batches
        for batch in (0, 1, 45):
            rows = randint(gen, 0, n, (batch,)).long()
            rows[:1] = 1
            found = torch.rand(batch, generator=gen, device="cuda") < 0.8
            ordr = order[rows].long()
            c_ord = torch.where(found.unsqueeze(1),
                                torch.gather(cnt2[rows], 1, ordr), 0)
            d_ord = torch.gather(dst2[rows], 1, ordr)
            for max_items in (1, 16, c + 3):
                for t in (0.0, 0.5, 0.9, 1.0, None):
                    both(f"cdf_query C={c} B={batch} k={max_items} t={t}",
                         ops.cdf_query, c_ord, d_ord, tot2[rows], t,
                         max_items=max_items)

    # oddeven where its row geometry changes (a row's lanes 1, 2, 4, ...,
    # 32, so 32 rows a warp down to 1), odd row counts, the tensors aligned
    # (16-byte vectors) and 4 B off a 16 B boundary (int32 loads); both
    # forms, the in-place one on the misaligned tensors themselves
    for c in (1, 2, 3, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 128, 1000):
        for n in (1, 37, 2049):
            _, cnt, _, _ = random_slabs(gen, n, c)
            small = torch.where(cnt > 0, cnt % 4, 0).to(torch.int32)
            perm = random_perm_rows(gen, n, c)
            for place in (lambda x: x.clone(), misaligned):
                for passes in (1, 3):
                    tag = (f"oddeven C={c} N={n} passes={passes}"
                           f"{'' if place is misaligned else ' aligned'}")
                    both(tag, ops.oddeven_sort, place(small), place(perm),
                         passes=passes)
                    outs = []
                    for impl in ("cuda", "ref"):
                        order, dirty = place(perm), torch.zeros(
                            n, dtype=torch.uint8, device="cuda")
                        dirty[::5] = 1
                        ops.oddeven_sort_(place(small), order, passes=passes,
                                          dirty=dirty, impl=impl)
                        outs.append([order, dirty])
                    torch.cuda.synchronize()
                    compare(tag + " (in place, flags)", *outs)
                    checked += 1

    # probe: tombstone chains, wrap-around, saturated windows, padding rows,
    # the home slot alone; keys -1 (EMPTY: a miss without a read) and -2
    # (TOMB); the stacked mode (dh_find) beside the flat one (ht_find) with
    # both miss values
    for n, h, max_probes, fill, delete_frac in (
            (4, 32, 32, 12, 0.0), (3, 16, 8, 14, 0.5), (2, 8, 16, 7, 0.4),
            (5, 64, 4, 40, 0.9), (1, 1, 3, 1, 0.0), (3, 16, 1, 10, 0.3),
            (3, 512, 64, 150, 0.6)):
        keys, vals = build_tables(gen, n, h, max_probes, fill, delete_frac)
        for batch in (0, 1, 203):
            rows = randint(gen, -1, n, (batch,))
            q = randint(gen, 0, 520, (batch,))
            q[::5] = -1
            q[3::11] = -2
            both(f"dh_find N={n} H={h} P={max_probes} B={batch}", ops.dh_find,
                 rows, q, keys, vals, max_probes=max_probes)
            for miss in (-1, 0):
                both(f"ht_find H={h} P={max_probes} B={batch} miss={miss}",
                     ops.ht_find, q, keys[0].contiguous(),
                     vals[0].contiguous(), max_probes=max_probes, miss=miss)

    # slow path: rows and slots running out, tiny table with a short window;
    # the in-place form's table flags (a group of 32 slots, or a table of
    # 16) held equal too
    from repro_torch.core import mcprioq as mc
    from repro_torch.core.hashtable import flag_count
    for num_rows, c, table_size, max_probes in (
            (16, 4, 0, 64), (64, 8, 16, 2), (32, 3, 0, 8), (8, 1, 0, 4)):
        cfg = mc.MCConfig(num_rows=num_rows, capacity=c, table_size=table_size,
                          max_probes=max_probes)
        st = mc.init(cfg)
        for step in range(4):
            items = 0 if step == 3 else 50
            src = randint(gen, 0, 40, (items,))
            dsts = randint(gen, 0, 12, (items,))
            w = randint(gen, 1, 5, (items,))
            active = torch.rand(items, generator=gen, device="cuda") < 0.8
            counters = torch.stack([st.n_rows, st.dropped_rows,
                                    st.dropped_probes, st.evictions])
            args = (st.src_table.keys, st.src_table.vals, st.slabs.dst,
                    st.slabs.cnt, st.slabs.tot, st.slabs.order, counters, src,
                    dsts, w, active)
            both(f"slow_path N={num_rows} C={c} H={cfg.resolved_table_size()} "
                 f"P={max_probes} step={step}", ops.slow_path, *args,
                 max_probes=max_probes)
            both_(f"slow_path N={num_rows} C={c} step={step}", ops.slow_path_,
                  (0, 1, 2, 3, 4, 6), *args, max_probes=max_probes,
                  table_dirty=torch.zeros(
                      flag_count(cfg.resolved_table_size()),
                      dtype=torch.uint8, device="cuda"),
                  written_kw=("table_dirty",))
            st = mc._slow_path(st, src, dsts, w, active, cfg)
            st = st._replace(slabs=st.slabs._replace(
                order=random_perm_rows(gen, num_rows, c)))
    for group in (lambda: small_slab_cdf_checks(gen, both, both_),
                  lambda: small_decay_checks(gen, both, both_),
                  lambda: small_dh_checks(gen, both, both_),
                  lambda: small_copy_checks(gen),
                  lambda: small_topn_checks(gen, both),
                  lambda: small_topn_windows_checks(gen)):
        t0 = time.perf_counter()
        group()
        took(f"kernels, {checked} comparisons so far", t0)
    walk_ok = small_walk_checks(gen, both)
    say(f"[kernels] {checked} small-shape comparisons, kernel == plain version "
        f"(torch.equal) in all; {walk_ok} ok draft steps among the walks")
    t0 = time.perf_counter()
    large_slow_path_checks(gen)
    took("kernels, the large new-edge checks", t0)


def misaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 B past a 16 B boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def sorted_batch(gen, dst, heavy=40, tail=9):
    """Items as the update hands them to ``slab_update``: sorted by (row,
    dst) over a few rows, one row with ``heavy`` items (more than a warp),
    repeated edges, a share of slots -1 among them (the aggregation's
    non-heads and the new edges) and a -1 tail (inactive items)."""
    n, c = dst.shape
    rows = torch.cat([torch.full((heavy,), n // 2, dtype=torch.int32,
                                 device="cuda"), randint(gen, 0, n, (50,))])
    dsts = dst[rows.long(), randint(gen, 0, c, (rows.numel(),)).long()]
    dsts[::7] = 54321                                    # absent edges
    key = rows.long() * (1 << 32) + dsts.long() + (1 << 31)
    perm = torch.sort(key, stable=True).indices
    rows, dsts = rows[perm], dsts[perm].to(torch.int32)
    rows[torch.rand(rows.numel(), generator=gen, device="cuda") < 0.2] = -1
    pad = torch.full((tail,), -1, dtype=torch.int32, device="cuda")
    w = randint(gen, 1, 9, (rows.numel() + tail,))
    return torch.cat([rows, pad]), torch.cat([dsts, pad]), w


def small_slab_cdf_checks(gen, both, both_):
    """``slab_update`` (both forms) and ``cdf_query`` at the shapes their
    designs branch on: rows of 1 to 1,024 slots (one scan step or many; a
    lane's 4 slots or V positions cut by the row's end), rows 4 B past a
    16 B boundary (scalar loads), a sorted batch with a row of more items
    than a warp and a -1 tail, and 65,543 items over 37 rows in random order
    (many blocks, many items per row in one warp: the combined tot
    atomics)."""
    from repro_torch.kernels import ops
    for c in (1, 3, 16, 33, 64, 128, 129, 1024):
        n = 37
        dst, cnt, tot, order = random_slabs(gen, n, c)
        dst[3] = torch.where(cnt[3] > 0, 77, -1)        # repeated dst: first slot
        many = randint(gen, 0, n, (65_536 + 7,))
        hit = dst[many.long(), randint(gen, 0, c, (many.numel(),)).long()]
        batches = {"sorted": sorted_batch(gen, dst),
                   "65,543 items": (many, hit, randint(gen, -3, 9,
                                                       (many.numel(),)))}
        for label, (rows, dsts, w) in batches.items():
            for skew, slab in (("", dst), (" misaligned", misaligned(dst))):
                name = f"slab_update C={c} {label}{skew}"
                both(name, ops.slab_update, rows, dsts, w, slab, cnt, tot)
                both_(name, ops.slab_update_, (4, 5), rows, dsts, w, slab,
                      misaligned(cnt) if skew else cnt,
                      misaligned(tot) if skew else tot)
        # cdf over pre-ordered rows, aligned and 4 B off, both modes
        if c not in (33, 64, 128, 129, 1024):
            continue
        rows = randint(gen, 0, n, (45,)).long()
        found = torch.rand(45, generator=gen, device="cuda") < 0.8
        ordr = order[rows].long()
        c_ord = torch.where(found.unsqueeze(1), torch.gather(cnt[rows], 1, ordr), 0)
        d_ord = torch.gather(dst[rows], 1, ordr)
        for skew, (co, do) in (("", (c_ord, d_ord)),
                               (" misaligned", (misaligned(c_ord),
                                                misaligned(d_ord)))):
            for max_items in (1, 16, c + 3):
                for t in (0.0, 0.5, 0.9, 1.0, None):
                    both(f"cdf_query C={c} B=45 k={max_items} t={t}{skew}",
                         ops.cdf_query, co, do, tot[rows], t,
                         max_items=max_items)


def small_copy_checks(gen):
    """The catch-up against its plain version: back buffers of random rows,
    row flags scattered (a random share, none, all) or clustered (a run of
    consecutive rows, as new rows take them), table flags on some slot
    groups (a group of 32, or a whole table smaller than 32), row hashes
    on (H 1 to 4,096) and off, stacked states of S = 1, 4, 40 and 257 (the rows,
    tables and scalars of every shard flat); the functional wrapper and the
    bound launch the learner makes, each equal to the plain version: the
    back's tensors and both flags cleared."""
    from repro_torch.core import hashtable as ht
    from repro_torch.kernels import ops
    cases = 0
    for s_, n, c, t, share, dh, cluster in (
            (1, 37, 1, 1, 0.3, 0, 0), (1, 37, 5, 16, 0.0, 0, 0),
            (1, 40, 32, 64, 1.0, 0, 0), (1, 41, 128, 1024, 0.3, 0, 0),
            (1, 1000, 300, 4096, 0.1, 0, 0), (1, 37, 5, 16, 0.4, 1, 0),
            (1, 41, 128, 64, 0.3, 8, 0), (1, 300, 128, 4096, 0.2, 512, 0),
            (1, 33, 7, 32, 1.0, 4096, 0), (1, 5000, 64, 32768, 0.0, 1, 188),
            (1, 5000, 16, 8192, 0.02, 0, 700), (4, 3000, 128, 2048, 0.05, 1, 90),
            (4, 1025, 16, 16, 0.3, 0, 0), (40, 300, 5, 16, 0.3, 0, 0),
            (40, 257, 64, 1024, 0.1, 1, 40),
            # 2,570 scalars: more than the scalar block's threads
            (257, 8, 3, 8, 0.5, 0, 0)):
        rows, slots = s_ * n, s_ * t
        front = [*random_slabs(gen, rows, c)]
        back = [*random_slabs(gen, rows, c)]
        tables = [randint(gen, -2, 500, (slots,)) for _ in range(4)]
        scalars = [randint(gen, 0, 99, (10 * s_,)) for _ in range(2)]
        hashes = [randint(gen, -2, 500, (rows, dh)) for _ in range(4)] if dh else []
        flags = (torch.rand(rows, generator=gen, device="cuda") < share).to(torch.uint8)
        if cluster:   # new rows: a run of consecutive rows in one shard
            at = int(torch.randint(0, n - cluster, (1,), generator=gen,
                                   device="cuda"))
            flags[at:at + cluster] = 1
        groups = s_ * ht.flag_count(t)
        table_flags = (torch.rand(groups, generator=gen, device="cuda")
                       < 0.3).to(torch.uint8)
        f = (front[1], front[0], front[3], front[2], *tables[:2], scalars[0],
             *hashes[:2])
        outs = []
        for how in ("cuda", "bound", "ref"):
            b = [x.clone() for x in back] + [x.clone() for x in tables[2:]] \
                + [scalars[1].clone()] + [x.clone() for x in hashes[2:]]
            fl = (flags.clone(), table_flags.clone())
            work = (b[1], b[0], b[3], b[2], *b[4:])
            if how == "bound":
                ops.copy_bound_rows(ops.bind_copy_dirty_rows(f, work, *fl))
            else:
                ops.copy_dirty_rows(f, work, *fl, impl=how)
            outs.append(b + list(fl))
        torch.cuda.synchronize()
        for how, got in zip(("functional", "bound"), outs):
            compare(f"copy_dirty_rows {how} S={s_} N={n} C={c} T={t} row "
                    f"hashes H={dh} flagged {share} + a run of {cluster}",
                    got, outs[2])
        cases += 1
    say(f"[kernels] copy_dirty_rows: {cases} cases, the functional and the "
        f"bound launch each equal to the plain version (torch.equal, both "
        f"flags cleared): row flags scattered and clustered, table flags, "
        f"row hashes of width 1 to 4,096 and none, S = 1, 4, 40 and 257")


def small_decay_checks(gen, both, both_):
    """The fused decay against its plain version (the odd-even composition)
    and against the plain mirror of its own decomposition, at every register
    shape from 1 to 256 slots: random counts, ties over a row, all-zero rows,
    counts of 1 (every edge evicted), counts up to 2^31 - 1, free
    slots among live ones; ``order`` a random permutation, and the order the
    counts already have (rows the kernel keeps as they are); then the
    rolling form with
    r not dividing n, the cursor at the clamped last block, past it and
    negative, and its contract: the inputs are not written."""
    from repro_torch.kernels import ops, ref
    for c in (1, 2, 3, 5, 31, 32, 33, 64, 96, 128, 160, 256):
        n = 41
        _, cnt, _, _ = random_slabs(gen, n, c)
        cnt[1] = 6
        cnt[2] = 0
        cnt[3] = 1
        cnt[4] = randint(gen, 1, 4, (c,))
        cnt[5] = randint(gen, 0, 2 ** 31 - 1, (c,))
        cnt[6] = randint(gen, 0, 3, (c,)) * 2
        dst = torch.where(cnt > 0, randint(gen, 0, 10_000, (n, c)), -1).to(torch.int32)
        # a random permutation, and the order the counts already have
        ordered = torch.sort(-cnt, dim=1, stable=True).indices.to(torch.int32)
        for label, perm in (("", random_perm_rows(gen, n, c)),
                            (" sorted rows", ordered)):
            got = both(f"decay_sort C={c}{label}", ops.decay_sort, cnt, dst, perm)
            compare(f"decay_sort C={c}{label} vs its decomposition", got,
                    ref.decay_sort_rows_ref(cnt, dst, perm))
            tot = cnt.sum(dim=1).to(torch.int32)
            for fire in (None, True, False):
                fire_t = None if fire is None else torch.tensor(fire, device="cuda")
                both_(f"decay_sort_ C={c}{label} fire={fire}", ops.decay_sort_,
                      (0, 1, 2, 3), cnt, dst, perm, tot, fire=fire_t)
    n, c, r = 37, 24, 10
    dst, cnt, tot, order = random_slabs(gen, n, c, hi=40)
    order = random_perm_rows(gen, n, c)
    saved = [x.clone() for x in (cnt, dst, order, tot)]
    for block_rows in (1, r, n):
        for cur in (0, 2, 3, 4, 9, -1, 2 ** 31 - 1):
            cursor = torch.tensor(cur, dtype=torch.int32, device="cuda")
            both(f"decay_sort_rolling n={n} r={block_rows} cursor={cur}",
                 ops.decay_sort_rolling, cnt, dst, order, tot, cursor,
                 block_rows=block_rows)
            for fire in (None, True, False):
                fire_t = None if fire is None else torch.tensor(fire, device="cuda")
                both_(f"decay_sort_rolling_ n={n} r={block_rows} cursor={cur} "
                      f"fire={fire}", ops.decay_sort_rolling_, (0, 1, 2, 3, 4),
                      cnt, dst, order, tot, cursor, block_rows=block_rows,
                      fire=fire_t)
    for x, y in zip((cnt, dst, order, tot), saved):
        if not torch.equal(x, y):
            raise AssertionError("decay_sort_rolling wrote into its inputs")


def hash_chain(gen, n, c, h, max_probes, tomb_share):
    """A chain with row hashes learned on the card through the plain
    versions (random traffic that fills rows and evicts, rolling decays
    that leave tombstones, no rebuild), then a share of the EMPTY lanes
    made TOMB: windows saturated with tombstones.  Returns ``(cfg,
    state)``."""
    from repro_torch.core import mcprioq as mc
    cfg = mc.MCConfig(num_rows=n, capacity=c, max_probes=max_probes,
                      use_dst_hash=True, dst_table_size=h,
                      decay_block_rows=max(n // 3, 1),
                      dh_rebuild_fraction=100.0, impl="ref")
    st = mc.init(cfg)
    for _ in range(4):
        src = randint(gen, 0, n + n // 4, (6 * n,))
        dst = randint(gen, 0, 3 * c, (6 * n,))
        st = mc.decay(mc.update_batch(st, src, dst, cfg=cfg), cfg=cfg)
    tomb = (st.dh_keys == -1) & (
        torch.rand(st.dh_keys.shape, generator=gen, device="cuda") < tomb_share)
    return cfg, st._replace(dh_keys=torch.where(tomb, -2, st.dh_keys)
                            .to(torch.int32).contiguous())


def small_dh_checks(gen, both, both_):
    """The dst-hash path's device code against its plain versions, on row
    hashes learned on the card: H of 1, 8, 64 and 512, windows wrapping
    small tables, windows saturated with tombstones, a window that fills
    (an insert that finds no lane drops the key), capacities up to 128.
    The new-edge pass with the row-hash edits (functional and in place);
    the decay with the repair (whole table, rolling, ``fire`` each way,
    functional and in place); the rebuild with thresholds either side of
    the tombstones, ``fire`` each way and an all-zero row."""
    from repro_torch.kernels import ops
    cases = 0
    for n, c, h, probes, tomb_share in (
            (37, 5, 1, 4, 0.0), (29, 8, 8, 16, 0.9), (23, 8, 8, 4, 0.0),
            (13, 33, 64, 40, 0.95), (17, 128, 512, 64, 0.5)):
        cfg, st = hash_chain(gen, n, c, h, probes, tomb_share)
        label = f"N={n} C={c} H={h} P={probes} TOMB {tomb_share}"
        slabs, dh = st.slabs, dict(dh_keys=st.dh_keys, dh_vals=st.dh_vals)
        for items in (0, 1, 4 * n):
            src = randint(gen, 0, n + n // 2, (items,))
            dsts = randint(gen, 0, 4 * c, (items,))
            w = randint(gen, 1, 5, (items,))
            active = torch.rand(items, generator=gen, device="cuda") < 0.85
            counters = torch.stack([st.n_rows, st.dropped_rows,
                                    st.dropped_probes, st.evictions])
            args = (st.src_table.keys, st.src_table.vals, slabs.dst, slabs.cnt,
                    slabs.tot, slabs.order, counters, src, dsts, w, active)
            both(f"slow_path+row hashes {label} L={items}", ops.slow_path,
                 *args, max_probes=probes, **dh)
            both_(f"slow_path_+row hashes {label} L={items}", ops.slow_path_,
                  (0, 1, 2, 3, 4, 6), *args, max_probes=probes,
                  written_kw=("dh_keys", "dh_vals"), **dh)
            cases += 2
        tombs = st.dh_tombstones.reshape(())
        perm = random_perm_rows(gen, n, c)
        both(f"decay_sort+repair {label}", ops.decay_sort, slabs.cnt, slabs.dst,
             perm, **dh)
        for fire in (None, True, False):
            fire_t = None if fire is None else torch.tensor(fire, device="cuda")
            both_(f"decay_sort_+repair {label} fire={fire}", ops.decay_sort_,
                  (0, 1, 2, 3), slabs.cnt, slabs.dst, perm, slabs.tot,
                  fire=fire_t, tombstones=tombs,
                  written_kw=("dh_keys", "tombstones"), **dh)
            for block, cur in ((1, 5), (7, 2), (7, -1), (n, 3)):
                cursor = torch.tensor(cur, dtype=torch.int32, device="cuda")
                both_(f"decay_sort_rolling_+repair {label} r={block} "
                      f"cursor={cur} fire={fire}", ops.decay_sort_rolling_,
                      (0, 1, 2, 3, 4), slabs.cnt, slabs.dst, perm, slabs.tot,
                      cursor, block_rows=block, fire=fire_t, tombstones=tombs,
                      written_kw=("dh_keys", "tombstones"), **dh)
                cases += 1
            cnt0 = slabs.cnt.clone()
            cnt0[0] = 0                      # an all-zero row: an EMPTY table
            held = int(tombs)
            for threshold in (held - 1, held, -1, 2 ** 31 - 1):
                counters = torch.stack([st.dh_rebuilds, tombs])
                both_(f"dh_rebuild_ {label} tombstones {held} threshold "
                      f"{threshold} fire={fire}", ops.dh_rebuild_, (2, 3, 4),
                      cnt0, slabs.dst, st.dh_keys, st.dh_vals, counters,
                      threshold=threshold, max_probes=probes, fire=fire_t)
                cases += 1
        cursor = torch.tensor(1, dtype=torch.int32, device="cuda")
        both(f"decay_sort_rolling+repair {label}", ops.decay_sort_rolling,
             slabs.cnt, slabs.dst, perm, slabs.tot, cursor, block_rows=5,
             tombstones=tombs, **dh)
        cases += 5
    say(f"[kernels] dst-hash path: {cases} cases (new-edge pass with row-hash "
        f"edits, decay with repair, rebuild) equal to the plain versions "
        f"(torch.equal), H from 1 to 512, tombstone-saturated and full windows")


def direct_table(gen, n_keys, size):
    """A src table of ``size`` slots holding ``n_keys`` random keys, each at
    its home slot, key ``srcs[r] -> r``.  Returns ``(keys, vals, srcs)``."""
    from repro_torch.core.hashtable import hash_u32
    cand = torch.randperm(16 * size, generator=gen, device="cuda").to(torch.int32)
    home = hash_u32(cand) & (size - 1)
    by_home = torch.sort(home, stable=True).indices
    first = torch.ones(by_home.numel(), dtype=torch.bool, device="cuda")
    first[1:] = home[by_home[1:]] != home[by_home[:-1]]
    srcs = cand[by_home[first]]
    srcs = srcs[torch.randperm(srcs.numel(), generator=gen, device="cuda")][:n_keys]
    if srcs.numel() != n_keys:
        raise AssertionError("direct_table: too few distinct home slots")
    keys = torch.full((size,), -1, dtype=torch.int32, device="cuda")
    vals = torch.full((size,), -1, dtype=torch.int32, device="cuda")
    slot = (hash_u32(srcs) & (size - 1)).long()
    keys[slot] = srcs
    vals[slot] = torch.arange(n_keys, dtype=torch.int32, device="cuda")
    return keys, vals, srcs


def large_slow_path_checks(gen):
    """The new-edge pass where one warp walking the items never went: long
    runs of items on a few rows, one item on each of thousands of rows, rows
    running out mid-pass behind a 2-slot probe window, more items than one
    block sorts (mostly inactive, and 30,000 active on 32,768 rows, so the
    merges have work), no active item; and the in-place / cloning contract.  Held
    equal (torch.equal) to the plain mirror of the kernel's decomposition,
    and once to the sequential plain version."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import slow_path as sp

    def state(n, c, n_keys, density=0.9):
        keys, vals, srcs = direct_table(gen, n_keys, 4 * n)
        dst, cnt, tot, order = random_slabs(gen, n, c, density=density, hi=50)
        counters = torch.tensor([n_keys, 0, 0, 0], dtype=torch.int32,
                                device="cuda")
        return (keys, vals, dst, cnt, tot, order, counters), srcs

    def new_srcs(count):
        return randint(gen, 1 << 28, (1 << 28) + count, (count,))

    checked = []

    def check(label, st, items, max_probes, plain=ref.slow_path_rows_ref):
        got = ops.slow_path(*st, *items, max_probes=max_probes, impl="cuda")
        torch.cuda.synchronize()
        compare(label, got, plain(*st, *items, max_probes))
        checked.append(label)
        return got

    def ones(count):
        return torch.ones(count, dtype=torch.bool, device="cuda")

    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")

    def kernel_ms(st, items, max_probes):
        """The kernel alone (in place, no copies) on these inputs."""
        work = [x.clone() for x in st]

        def restore():
            for dst_t, src_t in zip(work, st):
                dst_t.copy_(src_t)

        return time_restored(
            lambda: sp.slow_path_cuda_(
                *work, *items[:3], items[3].to(torch.int32),
                max_probes=max_probes), restore, flush)

    items = 8192
    st, srcs = state(4096, 32, 4096)
    few = srcs[randint(gen, 0, 4, (items,)).long()]
    out = check("slow_path 8192 items on 4 rows, C=32 (sequential plain)", st,
                (few, randint(gen, 0, 300, (items,)), randint(gen, 1, 5, (items,)),
                 ones(items)), 64, plain=ref.slow_path_ref)
    ev_few = int(out[5][3])
    few_ms = kernel_ms(st, (few, randint(gen, 0, 300, (items,)),
                            randint(gen, 1, 5, (items,)), ones(items)), 64)

    st, srcs = state(8192, 64, 8192)
    spread = (srcs[torch.randperm(items, generator=gen, device="cuda")],
              randint(gen, 0, 20_000, (items,)), randint(gen, 1, 5, (items,)),
              ones(items))
    out = check("slow_path 8192 items on 8192 rows, C=64", st, spread, 64)
    ev_spread = int(out[5][3])
    spread_ms = kernel_ms(st, spread, 64)
    # the contract: the functional form writes none of its inputs; the
    # in-place form writes the same result into the tensors it is given and
    # flags exactly the rows whose dst, cnt or tot changed
    saved = [x.clone() for x in st]
    got = ops.slow_path(*st, *spread, max_probes=64, impl="cuda")
    compare("slow_path functional result", got, out)
    for i, (a, b) in enumerate(zip(st, saved)):
        if not torch.equal(a, b):
            raise AssertionError(f"the functional slow_path wrote input {i}")
    own = [x.clone() for x in st]
    dirty = torch.zeros(st[3].shape[0], dtype=torch.uint8, device="cuda")
    ops.slow_path_(*own, *spread, max_probes=64, dirty=dirty, impl="cuda")
    compare("slow_path in place", own[:5] + own[6:], out)
    changed = ((own[2] != st[2]) | (own[3] != st[3])).any(dim=1) | (own[4] != st[4])
    if not torch.equal(dirty.bool(), changed):
        raise AssertionError("slow_path_: the flags are not the rows it changed")
    inactive = (spread[0], spread[1], spread[2], ~ones(items))
    check("slow_path 8192 inactive items", st, inactive, 64)

    st, srcs = state(4096, 16, 3500)
    known = srcs[randint(gen, 0, 3500, (items,)).long()]
    fresh = new_srcs(3000)[randint(gen, 0, 3000, (items,)).long()]
    mixed = torch.where(randint(gen, 0, 2, (items,)) == 1, known, fresh)
    out = check("slow_path rows running out mid-pass, 2^12 rows, max_probes=2",
                st, (mixed, randint(gen, 0, 40, (items,)),
                     randint(gen, 1, 5, (items,)), ones(items)), 2)
    n_rows, dropped_rows, dropped_probes, _ = out[5].tolist()
    if n_rows != 4096 or dropped_rows == 0 or dropped_probes == 0:
        raise AssertionError(f"rows-running-out case missed its point: {out[5]}")

    for length in (65_536, 8192 + 1234):
        st, srcs = state(4096, 16, 2000)
        pool = torch.cat([srcs, new_srcs(1500)])
        check(f"slow_path L={length}, 3 % active",
              st, (pool[randint(gen, 0, pool.numel(), (length,)).long()],
                   randint(gen, 0, 40, (length,)), randint(gen, 1, 5, (length,)),
                   torch.rand(length, generator=gen, device="cuda") < 0.03), 8)

    # more items with a row than two tiles hold: every tile sorts and two
    # levels of merges do real work, with one row's items in several tiles
    length, tile = 30_000, 8192
    st, srcs = state(32_768, 16, 30_000)
    pool = torch.cat([srcs, new_srcs(4000)])
    out = check(f"slow_path L={length} on 32768 rows, all active (merges)", st,
                (pool[randint(gen, 0, pool.numel(), (length,)).long()],
                 randint(gen, 0, 40, (length,)), randint(gen, 1, 5, (length,)),
                 ones(length)), 64)
    merged = length - int((out[5][1:3] - st[6][1:3]).sum())
    if merged <= 2 * tile:
        raise AssertionError(f"merge case: only {merged} items have a row")
    say(f"[kernels] slow_path at sizes one warp never met: {len(checked)} cases "
        f"equal to the plain versions (torch.equal; evictions {ev_few} on 4 rows, "
        f"{ev_spread} on 8192 rows; rows ran out with {dropped_rows} "
        f"dropped_rows and {dropped_probes} dropped_probes; {merged} items "
        f"with a row sorted in {-(-merged // tile)} tiles and merged), in-place and "
        f"cloning contract held; the kernel alone (no copies, median of 10): "
        f"{few_ms:.4f} ms for 8192 items on 4 rows, {spread_ms:.4f} ms on 8192 "
        f"rows")


def small_walk_checks(gen, both):
    """The draft walk on chains learned on the card, with a share of their
    src keys tombstoned (small tables: chains wrap) and a few order heads
    pointing at a slot whose count is 0; windows of learned contexts (dead
    ends mid-walk come from the stream's noise) and unknown ones, read as
    strided views of wider contexts; then rows wider than the lanes of a
    sequence hold in registers, order heads anywhere in them."""
    from repro_torch.core import hashtable as ht
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import speculative as spec
    from repro_torch.kernels import ops
    vocab, seqs, length = 40, 6, 96
    walk_ok = 0

    def check(label, args, k, max_probes):
        nonlocal walk_ok
        _, ok = both(label, ops.draft_walk, *args, k=k, max_probes=max_probes)
        walk_ok += int(ok.sum())

    span = torch.arange(8, device="cuda")
    for order_n, table_size in ((1, 0), (2, 0), (2, 64), (3, 64), (5, 0)):
        ncfg = spec.NGramConfig(order=order_n, mc=mc.MCConfig(
            num_rows=48, capacity=8, table_size=table_size, max_probes=16,
            sort_passes=2, impl="cuda"))
        succ = randint(gen, 0, vocab, (vocab,))
        toks = torch.empty((seqs, length), dtype=torch.int32, device="cuda")
        toks[:, 0] = randint(gen, 0, vocab, (seqs,))
        for i in range(1, length):
            keep = torch.rand(seqs, generator=gen, device="cuda") < 0.9
            toks[:, i] = torch.where(keep, succ[toks[:, i - 1].long()],
                                     randint(gen, 0, vocab, (seqs,)))
        chain = spec.observe(spec.init(ncfg), toks, cfg=ncfg).chain
        table = chain.src_table
        live = table.keys[table.keys >= 0]
        dead = torch.rand(live.numel(), generator=gen, device="cuda") < 0.2
        for key in live[dead].tolist():
            table, _ = ht.delete(table, key, ncfg.mc.max_probes)
        cnt = chain.slabs.cnt.clone()
        stale = randint(gen, 0, ncfg.mc.num_rows, (6,)).long()
        cnt[stale, chain.slabs.order[stale, 0].long()] = 0

        def windows(batch):
            pos = randint(gen, 8, length, (batch,)).long()
            seq = randint(gen, 0, seqs, (batch,)).long()
            ctx = toks[seq.unsqueeze(1), pos.unsqueeze(1) - 8 + span]
            unknown = torch.rand(batch, generator=gen, device="cuda") < 0.1
            return torch.where(unknown.unsqueeze(1), ctx + 5000, ctx)[:, -order_n:]

        for k in (1, 4, 8):
            for batch in (0, 1, 77):
                check(f"draft_walk order={order_n} T={table.keys.numel()} k={k} "
                      f"B={batch}", (windows(batch), table.keys, table.vals, cnt,
                                     chain.slabs.dst, chain.slabs.order[:, 0]),
                      k, ncfg.mc.max_probes)
    # rows of 160 slots (wider than 16 lanes x 8 registers): random counts,
    # dsts from the vocabulary so walks go on, order heads anywhere
    wide = 160
    cnt_w = randint(gen, 0, 4, (ncfg.mc.num_rows, wide))
    dst_w = torch.where(cnt_w > 0, randint(gen, 0, vocab, cnt_w.shape), -1)
    ord_w = randint(gen, 0, wide, (ncfg.mc.num_rows, 2))
    for k in (4, 8):
        check(f"draft_walk C={wide} k={k} B=77",
              (windows(77), table.keys, table.vals, cnt_w.to(torch.int32),
               dst_w.to(torch.int32), ord_w[:, 0]), k, ncfg.mc.max_probes)
    if walk_ok == 0:
        raise AssertionError("draft_walk checks: no lane ever drafted a token")
    return walk_ok


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

NUM_NODES = 2 ** 20
OUT_DEGREE = 32
BATCH = 65_536
QUERIES = 4_096


class Traffic:
    """Zipf transition stream made on the device: uniform ``src`` over
    ``nodes`` (2**20) nodes, Zipf(1.5) rank over 32 successors, ``dst`` a
    fixed hash of ``(src, rank)``."""

    def __init__(self, seed, nodes=NUM_NODES):
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(seed)
        self.nodes = nodes
        ranks = torch.arange(1, OUT_DEGREE + 1, device="cuda", dtype=torch.float64)
        self.probs = (ranks ** -1.5 / (ranks ** -1.5).sum()).float()

    def batch(self, size):
        src = randint(self.gen, 0, self.nodes, (size,))
        return src, self.dsts(src)

    def dsts(self, src):
        """A successor of each src: its Zipf rank, hashed with the src."""
        from repro_torch.core.hashtable import hash_u32
        rank = torch.multinomial(self.probs, src.numel(), replacement=True,
                                 generator=self.gen)
        return (hash_u32(src.long() * OUT_DEGREE + rank) & 0x7FFFFFFF).to(torch.int32)

    def srcs(self, size):
        return randint(self.gen, 0, self.nodes + self.nodes // 16, (size,))


def kernel_modules():
    from repro_torch.kernels import (cdf_gather, cdf_query, copy_rows,
                                     decay_sort, dh_rebuild, oddeven, probe,
                                     slab_update, slow_path, topn_merge,
                                     topn_windows, walk)
    return {"probe_find": probe, "slab_update": slab_update, "oddeven": oddeven,
            "cdf_query_fused": cdf_gather, "slow_path": slow_path,
            "cdf_query": cdf_query, "draft_walk": walk, "decay_sort": decay_sort,
            "copy_dirty_rows": copy_rows, "dh_rebuild": dh_rebuild,
            "topn_merge": topn_merge, "topn_windows": topn_windows}



@contextlib.contextmanager
def launch_window(label, need):
    """Every kernel's launch count is set to 0 on entry and read on exit into
    the yielded dict; fails if a kernel in ``need`` was never launched."""
    mods = kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    launches = {}
    yield launches
    torch.cuda.synchronize()
    launches.update({name: mod.launches for name, mod in mods.items()})
    say(f"[{label}] kernel launches: {launches}")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: path never launched {missing}")


def no_sync(fn, *args, **kw):
    """Run ``fn`` with PyTorch raising on any synchronising CUDA call."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def timed(times, key, fn, *args, **kw):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kw)
    end.record()
    times.setdefault(key, []).append((start, end))
    return out


MAIN_KERNELS = ("probe_find", "slab_update", "oddeven", "cdf_query_fused",
                "slow_path", "decay_sort")
SIDE_ROUNDS = 3         # rounds the owner calls are held to functional ones
COPY_OPS = ("aten::copy_", "aten::clone", "aten::_to_copy", "aten::cat",
            "aten::stack")
# the profiler's tries in no_state_copies and kernels_per_call: how long
# each trace stays open after the device has finished (seconds)
PROFILE_PADS_S = (0.05, 0.25, 1.0, 2.0, 4.0)


def no_state_copies(label, fn, rows, calls=3):
    """Run ``fn()`` ``calls`` times under torch.profiler with shapes
    recorded; fail if a copy op (every device-to-device memcpy and copy
    kernel is launched by one) copies a tensor of ``rows`` elements or more:
    a state leaf has at least one per row.  The copy kernels and memcpys it
    does launch — dtype casts, ``torch.sort``'s copy of its input and a
    slice assignment, all of the batch's items — are counted and
    printed.  The profiler can drop every kernel record of a short trace
    (a few hand-written kernels, with other processes on the card and the
    host's cores busy): each trace therefore stays open ``pad`` seconds
    after the device has finished, and a trace that holds no device kernel
    is taken again with a longer pad, up to ``len(PROFILE_PADS_S)`` times;
    one with none in every try fails."""
    from torch.profiler import ProfilerActivity, profile

    def trace(pad):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        return prof.events()

    def on_device(events):
        return [ev.name for ev in events
                if ev.device_type == torch.autograd.DeviceType.CUDA]

    for attempt, pad in enumerate(PROFILE_PADS_S):
        events = trace(pad)
        if on_device(events):
            break
        say(f"[kernels] {label}: the profiler recorded no device kernel "
            f"(try {attempt + 1} of {len(PROFILE_PADS_S)}, the trace held "
            f"open {pad} s after the device finished)")
    big = sorted({f"{ev.name}{ev.input_shapes}" for ev in events
                  if ev.name in COPY_OPS and any(
                      shape and int(torch.tensor(shape).prod()) >= rows
                      for shape in (ev.input_shapes or []))})
    device = on_device(events)
    memcpy = [k for k in device if "Memcpy DtoD" in k]
    casts = [k for k in device if "direct_copy" in k]
    say(f"[kernels] {label}: {len(device) / calls:g} device kernels per call "
        f"(torch.profiler, {calls} calls); per call {len(casts) / calls:g} "
        f"copy kernels and {len(memcpy) / calls:g} device-to-device memcpys, "
        f"all on tensors below {rows} elements; copies of {rows}+ elements: "
        f"{big or 'none'}")
    if not device:
        raise AssertionError(f"{label}: the profiler recorded no device kernel")
    if big:
        raise AssertionError(f"{label} copies state: {big}")


def main_config():
    from repro_torch import core
    return core.MCConfig(num_rows=NUM_NODES, capacity=128, sort_passes=1,
                         decay_block_rows=1024, max_new_per_batch=8192,
                         impl="auto")


def phase_main(seed, warm_batches, rounds):
    from repro_torch import core
    cfg = main_config()
    traffic = Traffic(seed)
    torch.cuda.reset_peak_memory_stats()
    state = core.init(cfg)
    say(f"[main] {cfg}")
    say(f"[main] table {cfg.resolved_table_size()} slots; state "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")

    # warm-up: a fixed number of batches, so the state the rounds meet (how
    # many of a batch's edges are new) does not follow the update's speed
    t0 = time.perf_counter()
    for batch in range(warm_batches):
        src, dst = traffic.batch(BATCH)
        core.update_batch_(state, src, dst, cfg=cfg)
        if batch % 10 == 9:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    stats = core.counter_stats(state)
    say(f"[main] warm-up: {warm_batches} batches of {BATCH} in "
        f"{time.perf_counter() - t0:.1f} s; n_rows {stats['n_rows']} "
        f"deferred_new {stats['deferred_new']}")

    # the owner calls against the functional calls on a side copy, every
    # leaf equal after each call of the first rounds
    decay_threshold = 64
    side = core.private_copy(state)
    for i in range(SIDE_ROUNDS):
        src, dst = traffic.batch(BATCH)
        out = core.update_batch_(state, src, dst, cfg=cfg)
        side = core.update_batch(side, src, dst, cfg=cfg)
        equal_states(f"main round {i}: update_batch_ vs update_batch", out, side)
        core.maybe_decay_(state, cfg=cfg, total_threshold=decay_threshold)
        side = core.maybe_decay(side, cfg=cfg, total_threshold=decay_threshold)
        equal_states(f"main round {i}: maybe_decay_ vs maybe_decay", state, side)
        if out is not state:
            raise AssertionError("update_batch_ returned another state")
    core.decay_(state, cfg=cfg)
    equal_states("main: decay_ vs decay", state, core.decay(side, cfg=cfg))
    del side, out
    say(f"[main] {SIDE_ROUNDS} rounds of update_batch_ + maybe_decay_ and one "
        f"decay_ (the owner calls, in place) equal to the functional calls on a "
        f"side copy: all 18 leaves after every call; peak device memory with "
        f"the side copy {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()

    # measured rounds: launch counts are read around exactly this block
    times = {}
    with launch_window("main", MAIN_KERNELS) as launches:
        for _ in range(rounds):
            src, dst = traffic.batch(BATCH)
            q = traffic.srcs(QUERIES)
            timed(times, "update_batch_", no_sync, core.update_batch_, state,
                  src, dst, cfg=cfg)
            answers = timed(times, "query_threshold", no_sync,
                            core.query_threshold, state, q, 0.9, cfg=cfg,
                            max_items=16)
            top = timed(times, "query_topk", no_sync, core.query_topk, state,
                        q, cfg=cfg, k=8)
            timed(times, "maybe_decay_", no_sync, core.maybe_decay_, state,
                  cfg=cfg, total_threshold=decay_threshold)
        # rolling decay: the block is found on the device, no host sync
        timed(times, "decay_", no_sync, core.decay_, state, cfg=cfg)
    # a trigger that does not fire: the decay's launches return at once
    steps = state.decay_steps.clone()
    for _ in range(rounds):
        timed(times, "maybe_decay_[no fire]", no_sync, core.maybe_decay_,
              state, cfg=cfg, total_threshold=2 ** 31 - 1)
    if not torch.equal(steps, state.decay_steps):
        raise AssertionError("maybe_decay_ decayed under a threshold no row passes")
    # the maintenance calls' device time (a spin kernel queued ahead keeps
    # the host's launch time out of it) and their latency on an idle device
    for key, fn in (
            ("decay_", lambda: core.decay_(state, cfg=cfg)),
            ("maybe_decay_", lambda: core.maybe_decay_(
                state, cfg=cfg, total_threshold=decay_threshold)),
            ("maybe_decay_[no fire]", lambda: core.maybe_decay_(
                state, cfg=cfg, total_threshold=2 ** 31 - 1))):
        device_ms, idle_ms = call_ms(lambda fn=fn: no_sync(fn))
        say(f"[main] {key}: device {device_ms:.4f} ms, latency on an idle "
            f"device {idle_ms:.4f} ms (medians of 20, in turns)")
    torch.cuda.synchronize()
    batches = iter([traffic.batch(BATCH) for _ in range(3)])
    no_state_copies("update_batch_", lambda: core.update_batch_(
        state, *next(batches), cfg=cfg), cfg.num_rows)
    no_state_copies("decay_ (rolling)", lambda: core.decay_(state, cfg=cfg),
                    cfg.num_rows)

    med = {k: statistics.median(s.elapsed_time(e) for s, e in v)
           for k, v in times.items()}
    say(f"[main] {rounds} rounds; median ms per call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    say(f"[main] observe {BATCH / med['update_batch_'] * 1e3:.0f} edges/s; "
        f"query_threshold {QUERIES / med['query_threshold'] * 1e3:.0f} queries/s; "
        f"query_topk {QUERIES / med['query_topk'] * 1e3:.0f} queries/s "
        f"(device time by CUDA events, no synchronisation inside the calls)")
    say(f"[main] peak device memory over the rounds "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("[main] update_batch_, the queries, maybe_decay_ and one rolling "
        "decay_ ran under set_sync_debug_mode('error'): no device->host "
        "synchronisation")
    say(f"[main] counters {core.counter_stats(state)}")
    say(f"[main] maintenance {core.maintenance_stats(state)}")

    # the unfused read on the same state and srcs: the same answers, through
    # _ordered_rows + the kernel over pre-ordered rows
    cfg_u = dataclasses.replace(cfg, fused_query=False)
    with launch_window("main/unfused", ("probe_find", "cdf_query")) as unfused:
        for _ in range(rounds):
            ans_u = no_sync(core.query_threshold, state, q, 0.9, cfg=cfg_u,
                            max_items=16)
            top_u = no_sync(core.query_topk, state, q, cfg=cfg_u, k=8)
    launches["cdf_query"] = unfused["cdf_query"]
    compare("query_threshold unfused vs fused", ans_u,
            core.query_threshold(state, q, 0.9, cfg=cfg, max_items=16))
    compare("query_topk unfused vs fused", top_u,
            core.query_topk(state, q, cfg=cfg, k=8))
    calls = {
        "query_threshold": lambda c: core.query_threshold(state, q, 0.9, cfg=c,
                                                          max_items=16),
        "query_topk": lambda c: core.query_topk(state, q, cfg=c, k=8)}
    for key, call in calls.items():
        times_ms = [call_ms(lambda c=c: no_sync(call, c)) for c in (cfg, cfg_u)]
        say(f"[main] {key} fused / unfused: device {times_ms[0][0]:.4f} / "
            f"{times_ms[1][0]:.4f} ms, latency on an idle device "
            f"{times_ms[0][1]:.4f} / {times_ms[1][1]:.4f} ms (medians of 20, "
            f"in turns); answers equal")

    # beside the rounds: a batch whose edges all exist already (no new edge,
    # so the sequential pass is empty) — the chain's steady state
    table, slabs = state.src_table, state.slabs
    live_keys = table.keys >= 0
    src_of_row = torch.full((cfg.num_rows,), -1, dtype=torch.int32, device="cuda")
    src_of_row[table.vals[live_keys].long()] = table.keys[live_keys]
    rows = randint(traffic.gen, 0, max(stats["n_rows"], 1), (BATCH,)).long()
    top_slot = slabs.order[rows, 0].long()
    k_src, k_dst = src_of_row[rows], slabs.dst[rows, top_slot]
    k_mask = (slabs.cnt[rows, top_slot] > 0) & (k_src >= 0)
    steady = {}
    for _ in range(12):
        timed(steady, "update_batch", no_sync, core.update_batch_, state,
              k_src, k_dst, None, k_mask, cfg=cfg)
    torch.cuda.synchronize()
    steady_ms = statistics.median(
        s.elapsed_time(e) for s, e in steady["update_batch"][2:])
    say(f"[main] update_batch_ on {int(k_mask.sum())} existing edges only (empty "
        f"sequential pass): median {steady_ms:.3f} ms, "
        f"{BATCH / steady_ms * 1e3:.0f} edges/s")

    # what came out is right, by the chain's own checks
    inv = core.check_invariants(state, cfg)
    say(f"[main] invariants {inv}")
    if not all(v for k, v in inv.items() if k != "sorted_fraction"):
        raise AssertionError(f"invariants violated: {inv}")
    dk, pk, nn = answers
    if dk.shape != (QUERIES, 16) or pk.shape != (QUERIES, 16) or nn.shape != (QUERIES,) \
            or top[0].shape != (QUERIES, 8):
        raise AssertionError("query answers have the wrong shape")
    if not bool(torch.isfinite(pk).all()) or not bool(((pk >= 0) & (pk <= 1)).all()):
        raise AssertionError("probabilities are not finite values in [0, 1]")
    known = nn > 0
    if not bool(known.any()):
        raise AssertionError("no query found its src: the chain learned nothing")
    mass = pk.sum(dim=1)[known & (nn <= 16)]
    if mass.numel() and not bool((mass >= 0.9 - 1e-5).all()):
        raise AssertionError("a complete answer holds less than the threshold's mass")
    say(f"[main] queries: {int(known.sum())}/{QUERIES} srcs known, mean "
        f"n_needed {float(nn[known].float().mean()):.2f}")
    return state, cfg, traffic, launches, (k_src, k_dst, k_mask)


def profile_window(label, step, rounds=5):
    """Optional (``--profile``): device time by kernel name over ``rounds``
    calls of ``step()``, and the share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(f"{label}: {rounds} rounds", prof, wall_ms)


def report_profile(label, prof, wall_ms, lost_ok=False):
    """Device busy share of a profiled window and its top kernels by device
    time; returns the busy milliseconds.  ``lost_ok``: a window that
    launches only the hand-written kernels may come back with no device
    record at all in a long run (CUPTI loses them); then None is returned
    and the line says so, instead of raising."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue        # host-side ops repeat their kernels' device time
        device_us = getattr(ev, "self_device_time_total", None)
        if device_us is None:
            device_us = ev.self_cuda_time_total
        if device_us > 0:
            rows.append((device_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    say(f"[profile] {label} in {wall_ms:.1f} ms wall (profiler on); device "
        f"busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f} % of the window")
    if not rows:
        if lost_ok:
            say(f"[profile] {label}: the profiler recorded no device record "
                f"(not measured)")
            return None
        raise AssertionError("the profiler recorded no device time")
    for ms, count, key in rows[:12]:
        say(f"[profile]   {ms:9.3f} ms  {100 * ms / busy_ms:5.1f} %  x{count:<5d} {key[:90]}")
    return busy_ms


# ---------------------------------------------------------------------------
# phase 3b: each kernel at the main path's shapes, against its plain version
# ---------------------------------------------------------------------------


def bound(bytes_moved, operations):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = operations / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_entry(entries, launches, flush, name, module, source, replaces, run,
                 bytes_moved, operations, plain_reps=3, library=None, extra=None,
                 split=False, old=None):
    """Hold ``run("cuda")`` against ``run("ref")`` (equal), time both and the
    library call beside the bound, and append the kernel's line (with the
    keys of ``extra`` added; ``split``: the kernel's device time and its
    idle-device latency too, ``split_ms``; ``old()``: the kernel it
    replaced, held equal too and timed in turns with it, ``old_*``)."""
    got = run("cuda")
    torch.cuda.synchronize()
    want = run("ref")
    err = compare(name, got, want)
    if old is not None:
        compare(f"{name} (the kernel it replaced)", old(), want)
    del got, want
    ms = time_ms(lambda: run("cuda"), reps=10, warm=2, flush=flush)
    if split:
        extra = {**split_ms(lambda: run("cuda"), lambda: None, flush),
                 **(extra or {})}
    if old is not None:
        ms, old_ms = paired_restored((lambda: run("cuda"), old), lambda: None,
                                     flush)
        old_split = split_ms(old, lambda: None, flush)
        extra = {**(extra or {}), "old_ms": old_ms,
                 "old_device_ms": old_split["device_ms"],
                 "old_latency_ms": old_split["latency_ms"]}
    plain_ms = time_ms(lambda: run("ref"), reps=plain_reps,
                       warm=1 if plain_reps > 1 else 0, flush=flush)
    library_ms = None if library is None else time_ms(library, flush=flush)
    bound_ms, bound_by = bound(bytes_moved, operations)
    entries.append({
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": launches[module],
        "max_abs_err": err, "max_abs_diff": err, "equal": True,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, **(extra or {})})
    say(f"[kernels] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; equal"
        + "".join(f"; {k} {v:.4f}" if isinstance(v, float) else f"; {k} {v}"
                  for k, v in (extra or {}).items()))


def walk_length(c_ord, tot, t):
    """Positions of each pre-ordered row the walk must read: up to where the
    prefix crosses t * tot; all C in top-k mode or where it never crosses."""
    from repro_torch.core.hashtable import first_true
    b, c = c_ord.shape
    if t is None:
        return torch.full((b,), c, dtype=torch.int64, device=c_ord.device)
    t32 = torch.tensor(t, dtype=torch.float32, device=c_ord.device)
    tcnt = t32 * tot.clamp(min=1).to(torch.float32)
    cum = torch.cumsum(c_ord, dim=1, dtype=torch.int32).to(torch.float32)
    first, _ = first_true(cum >= tcnt.unsqueeze(1), dim=1)
    return (first + 1).clamp(max=c)


def probe_work(keys_q, keys, max_probes):
    """What a flat probe of ``keys_q`` must read, and its dependent round
    trips: ``(slots whose key is read + found slots' values, {trips})``.  A
    key -1 reads nothing; another reads its chain up to the key or EMPTY
    (the whole window if neither).  A query's trips are its key's load and
    one per probed slot (a slot's key and value come together)."""
    from repro_torch.core import hashtable as ht
    h = keys.shape[0]
    p = torch.arange(max_probes, device="cuda")
    win = keys[((ht.hash_u32(keys_q) & (h - 1)).unsqueeze(1) + p) & (h - 1)]
    key_p = ht.first_true(win == keys_q.unsqueeze(1), dim=1)[0]
    empty_p = ht.first_true(win == -1, dim=1)[0]
    probed = torch.minimum(key_p, empty_p).clamp(max=max_probes - 1) + 1
    probed = torch.where(keys_q == -1, 0, probed)
    found = (key_p < empty_p) & (keys_q != -1)
    trips = 1 + probed
    return int(probed.sum()) + int(found.sum()), {
        "trips_mean": float(trips.double().mean()), "trips_max": int(trips.max())}


def kernels_per_call(label, fn, modules, names, calls=20):
    """Device kernels per call of ``fn()``, counted by torch.profiler over
    ``calls`` calls, beside the launch counts of the wrappers in
    ``modules``.  Fails unless each wrapper launched its kernel once per
    call, every device kernel recorded is one of ``names`` (C kernel names)
    and there are at most ``len(names)`` per call.  The profiler can lose a
    kernel record (seen: 1 of 40, 2 of 20, 0 of 1), which only lowers the
    count, so up to ``len(PROFILE_PADS_S)`` sessions are run for an exact
    count, each held open a longer pad after the device finished, and a
    short one is reported as lost records; fewer than half the expected
    records fails, so a profiler that records nothing cannot pass."""
    from torch.profiler import ProfilerActivity, profile
    expect = len(names) * calls
    for pad in PROFILE_PADS_S:
        torch.cuda.synchronize()
        before = [m.launches for m in modules]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        kernels = [ev.name for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        counted = [m.launches - b for m, b in zip(modules, before)]
        if len(kernels) == expect:
            break
    other = sorted({k for k in kernels if not any(n in k for n in names)})
    say(f"[kernels] {label}: {len(kernels) / calls:g} device kernel(s) per "
        f"call by torch.profiler over {calls} calls "
        f"{sorted(set(k[:60] for k in kernels))}"
        + ("" if len(kernels) >= expect else
           f" ({expect - len(kernels)} record(s) lost by the profiler)")
        + "; launches per call: "
        + ", ".join(f"{m.__name__.split('.')[-1]} {c / calls:g}"
                    for m, c in zip(modules, counted)))
    if other or len(kernels) > expect or any(c != calls for c in counted):
        raise AssertionError(f"{label} is not {len(names)} device kernel(s) "
                             f"per call, one launch of each of {names}: "
                             f"other kernels {other}")
    if 2 * len(kernels) < expect:
        raise AssertionError(f"{label}: the profiler recorded {len(kernels)} of "
                             f"{expect} device kernels")


def path_shape_kernels(state, cfg, src, dst, q, launches, path=None,
                       reads=((0.9, 16), (None, 8)), unfused=True):
    """Recreate the inputs ``update_batch``/``query_*``/``decay`` hand each
    kernel (same functions, this state, one more batch ``src -> dst`` and the
    query srcs ``q``), hold the kernel against its plain version on them, and
    time both.  ``reads`` are the (threshold or None for top-k, max_items) of
    the path's queries; ``path`` tags the entries of a path other than the
    main one."""
    from repro_torch.core import mcprioq as mc
    from repro_torch.kernels import cdf_gather, decay_sort, ops, probe, ref

    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MiB
    n, c = cfg.num_rows, cfg.capacity
    slabs, table = state.slabs, state.src_table
    h = table.keys.shape[0]
    entries = []

    def label(kernel, variant):
        tags = [tag for tag in (path, variant) if tag]
        return f"{kernel}[{', '.join(tags)}]" if tags else kernel

    def entry(kernel, variant, *args, **kw):
        kernel_entry(entries, launches, flush, label(kernel, variant), kernel,
                     *args, **kw)

    def in_place(kernel, variant, *args, **kw):
        inplace_entry(entries, launches, flush, label(kernel, variant), kernel,
                      *args, **kw)

    # inputs as update_batch makes them
    src, dst, w, m = mc._batch_inputs(state, src, dst, None, None)
    batch, queries = src.shape[0], q.shape[0]
    u_src, u_dst, u_w, u_act, u_pos = mc._aggregate_batch(src, dst, w, m)
    rows0, found_src0 = mc.lookup_rows(state, u_src, cfg)
    _, found_d0 = mc._find_slots(state, rows0, u_dst, cfg)
    fast = u_act & found_src0 & found_d0
    fast_rows = torch.where(fast, rows0, -1)
    p_src, p_dst, p_w, p_mask, _ = mc._take_new_prefix(
        u_src, u_dst, u_w, u_pos, u_act & ~fast, cfg.resolved_max_new(batch))

    # probe, as lookup_rows calls it: flat mode, miss value 0; at the
    # update's keys (B = 65,536 aggregated items, -1 for non-head items) and
    # at the queries' srcs (B = 4,096)
    launch_floor = time_ms(lambda: torch.cuda._sleep(0), flush=flush)
    for variant, keys_q in ((None, u_src), ("query", q)):
        slot_reads, trips = probe_work(keys_q, table.keys, cfg.max_probes)
        entry("probe_find", variant, "probe.cu", "src/repro/kernels/probe.py:105",
              lambda impl, keys_q=keys_q: ops.ht_find(
                  keys_q, table.keys, table.vals, max_probes=cfg.max_probes,
                  miss=0, impl=impl),
              # keys in, slots + bool found out, the probed slots' keys and
              # the found slots' values
              bytes_moved=4 * (2 * keys_q.numel() + slot_reads) + keys_q.numel(),
              operations=12 * keys_q.numel() + 3 * slot_reads,
              extra=dict(launch_floor_ms=launch_floor, batch=keys_q.numel(),
                         **trips))
    if path is None:
        kernels_per_call(f"lookup_rows of {queries} srcs",
                         lambda: mc.lookup_rows(state, q, cfg), (probe,),
                         ("mcq_probe_find",))

    # slab_update: cnt/tot copied (read + write), items in, scanned row prefixes
    hit_slot = mc.ht.first_true(slabs.dst[rows0.long()] == u_dst.unsqueeze(1),
                                dim=1)[0] + 1
    scanned = int(torch.where(fast, hit_slot, 0).sum())
    found = int(fast.sum())
    del hit_slot
    # in place, as update_batch_ launches it: items in, the scanned row
    # prefixes, two atomics and a flag per found edge
    in_place("slab_update", None, "slab_update.cu",
             "src/repro/kernels/slab_update.py:75",
             lambda impl, work, dirty: ops.slab_update_(
                 fast_rows, u_dst, u_w, slabs.dst, *work, dirty=dirty,
                 impl=impl),
             (slabs.cnt, slabs.tot),
             bytes_moved=lambda flagged: 4 * (3 * batch + scanned + 4 * found)
             + flagged,
             operations=2 * scanned + 4 * batch)
    # functional: cnt/tot copied (read + write) first
    entry("slab_update", "functional", "slab_update.cu",
          "src/repro/kernels/slab_update.py:75",
          lambda impl: ops.slab_update(fast_rows, u_dst, u_w, slabs.dst,
                                       slabs.cnt, slabs.tot, impl=impl),
          bytes_moved=4 * (2 * n * c + 2 * n + 3 * batch + scanned + 2 * found),
          operations=2 * scanned + 4 * batch)

    # oddeven at the update's shape, in place as update_batch_ launches it:
    # cnt + order in, the changed rows of order out; functional: all of
    # order out
    in_place("oddeven", None, "oddeven.cu", "src/repro/kernels/oddeven.py:67",
             lambda impl, work, dirty: ops.oddeven_sort_(
                 slabs.cnt, *work, passes=cfg.sort_passes, dirty=dirty,
                 impl=impl),
             (slabs.order,),
             bytes_moved=lambda flagged: 4 * (2 * n * c + flagged * c) + flagged,
             operations=cfg.sort_passes * n * c * 3, split=True,
             old=lambda work, dirty: old_oddeven(slabs.cnt, work[0], work[0],
                                                 cfg.sort_passes, dirty))
    entry("oddeven", "functional", "oddeven.cu", "src/repro/kernels/oddeven.py:67",
          lambda impl: ops.oddeven_sort(slabs.cnt, slabs.order,
                                        passes=cfg.sort_passes, impl=impl),
          bytes_moved=4 * 3 * n * c,
          operations=cfg.sort_passes * n * c * 3, split=True,
          old=lambda: old_oddeven(slabs.cnt, slabs.order, None,
                                  cfg.sort_passes))

    # the decay: the rolling wrapper as decay launches it, then the kernel
    # alone on a block (and, on the main path, over the whole table as
    # stop-the-world decays it); the plain version halves and runs C//2+1
    # odd-even passes, torch.sort sorts the block's halved counts alone
    per_lane = 1
    while 32 * per_lane < c:
        per_lane *= 2
    log_p = (32 * per_lane).bit_length() - 1

    def sort_ops(rows):
        # two per compare-exchange of the network; halving, eviction, sum
        return rows * (16 * per_lane * log_p * (log_p + 1) + 3 * c)

    r = cfg.resolved_decay_rows()
    # in place, as decay_ launches it: the block's cnt, dst, order read and
    # written, its tot written, the cursor read and written, its flags set
    in_place("decay_sort", "rolling", "decay_sort.cu",
             "src/repro/kernels/ops.py:120",
             lambda impl, work, dirty: ops.decay_sort_rolling_(
                 *work, block_rows=r, dirty=dirty, impl=impl),
             (slabs.cnt, slabs.dst, slabs.order, slabs.tot, state.decay_cursor),
             bytes_moved=lambda flagged: 4 * (6 * r * c + r + 2) + flagged,
             operations=sort_ops(r), extra=dict(rows=r))
    entry("decay_sort", "rolling, functional", "decay_sort.cu",
          "src/repro/kernels/ops.py:120",
          lambda impl: ops.decay_sort_rolling(
              slabs.cnt, slabs.dst, slabs.order, slabs.tot, state.decay_cursor,
              block_rows=r, impl=impl),
          # cnt, dst, order, tot and the cursor read once, their copies (the
          # block decayed) and the next cursor written once
          bytes_moved=8 * (3 * n * c + n + 1), operations=sort_ops(r),
          extra=dict(rows=r, copies="included"))

    def decay_entry(variant, arrays, plain_reps=3):
        rows = arrays[0].shape[0]
        c_ord = torch.gather(arrays[0] >> 1, 1, arrays[2].long())
        entry("decay_sort", variant, "decay_sort.cu",
              "src/repro/kernels/ops.py:120",
              lambda impl: ops.decay_sort(*arrays, impl=impl),
              # cnt, dst, order read; the three and tot written
              bytes_moved=4 * (6 * rows * c + rows), operations=sort_ops(rows),
              plain_reps=plain_reps,
              library=lambda: torch.sort(c_ord, dim=1, descending=True,
                                         stable=True),
              extra=dict(rows=rows))

    block = [x[:r] for x in (slabs.cnt, slabs.dst, slabs.order)]
    decay_entry("block, kernel alone", block)
    if path is None:
        kernels_per_call(f"ops.decay_sort of {r} rows",
                         lambda: ops.decay_sort(*block), (decay_sort,),
                         ("mcq_decay_sort",))
        decay_entry("table", (slabs.cnt, slabs.dst, slabs.order), plain_reps=1)

    # fused query: threshold and top-k; per known src the positions it needs
    q_rows, q_found = mc.lookup_rows(state, q, cfg)
    for t, k in reads:
        _, _, nn = ref.cdf_query_fused_ref(q_rows, q_found, slabs.cnt, slabs.dst,
                                           slabs.order, slabs.tot, t, k)
        known = int(q_found.sum())
        walked = known * c if t is None else int(nn.sum())
        emitted = int(nn.clamp(max=k).sum())
        entry("cdf_query_fused", "topk" if t is None else None, "cdf_gather.cu",
              "src/repro/kernels/cdf_gather.py:95",
              lambda impl, t=t, k=k: ops.cdf_query_fused(
                  q_rows, q_found, slabs.cnt, slabs.dst, slabs.order, slabs.tot,
                  t, max_items=k, chunks=cfg.query_chunks, impl=impl),
              bytes_moved=4 * (2 * queries + known + 2 * walked + emitted
                               + queries * (2 * k + 1)),
              operations=8 * walked + 4 * queries * k)
        if path is None:
            kernels_per_call(
                f"query_{'topk' if t is None else 'threshold'} of {queries} srcs",
                (lambda t=t, k=k: mc.query_topk(state, q, cfg=cfg, k=k))
                if t is None else
                (lambda t=t, k=k: mc.query_threshold(state, q, t, cfg=cfg,
                                                     max_items=k)),
                (probe, cdf_gather), ("mcq_probe_find", "mcq_cdf_query_fused"))

    # the unfused read: the pre-ordered rows _ordered_rows hands the kernel
    if unfused:
        c_u, d_u, tot_u, _ = mc._ordered_rows(state, q, cfg)
        for t, k in reads:
            _, _, nn = ref.cdf_query_ref(c_u, d_u, tot_u, t, k)
            walked = int(walk_length(c_u, tot_u, t).sum())
            emitted = int(nn.clamp(max=k).sum())
            entry("cdf_query", "topk" if t is None else None, "cdf_query.cu",
                  "src/repro/kernels/cdf_query.py:154",
                  lambda impl, t=t, k=k: ops.cdf_query(
                      c_u, d_u, tot_u, t, max_items=k, chunks=cfg.query_chunks,
                      impl=impl),
                  bytes_moved=4 * (walked + emitted + queries
                                   + queries * (2 * k + 1)),
                  operations=8 * walked + 4 * queries * k)
        del c_u, d_u, tot_u

    # slow path, as update_batch calls it (cnt/tot its own)
    counters = torch.stack([state.n_rows, state.dropped_rows,
                            state.dropped_probes, state.evictions])
    slow_path_entry(entries, launches, flush,
                    "slow_path" + (f"[{path}]" if path else ""), cfg, table,
                    slabs, counters, (p_src, p_dst, p_w, p_mask),
                    sequential=path is None)
    return entries


def inplace_entry(entries, launches, flush, name, module, source, replaces,
                  run, written, bytes_moved, operations, plain_reps=3,
                  flags=None, extra=None, library=None, split=False, old=None):
    """An in-place form: ``run(impl, work, dirty)`` writes into ``work``
    (copies of the tensors ``written``) and into ``dirty`` (uint8, one per
    row; a copy of ``flags``, or zeros).  Held equal to its plain version on
    copies, the flags included; then timed in place, each call after the
    copies are restored (not timed).  ``bytes_moved(flagged rows)`` gives
    the bound: the rows flagged in ``flags``, or by the call.
    ``library()``, where given, computes the same tensors with PyTorch
    calls (held equal too) and is timed as ``library_ms``.  ``split``: the
    kernel's device time and its idle-device latency too (``split_ms``).
    ``old(work, dirty)``: the kernel it replaced, held equal too, timed in
    turns with it (``old_*``)."""
    rows = next(x.shape[0] for x in written if x.dim() == 2)
    if flags is None:
        flags = torch.zeros(rows, dtype=torch.uint8, device="cuda")
    outs = []
    for impl in ("cuda", "ref"):
        work = [x.clone() for x in written]
        dirty = flags.clone()
        run(impl, work, dirty)
        outs.append(work + [dirty])
        torch.cuda.synchronize()
    err = compare(f"{name} (in place, flags)", *outs)
    if old is not None:
        work, dirty = [x.clone() for x in written], flags.clone()
        old(work, dirty)
        compare(f"{name} (the kernel it replaced, in place)", work + [dirty],
                outs[1])
    if library is not None:
        compare(f"{name} (the library calls)", library(), outs[0][:-1])
    flagged = int(torch.maximum(flags, outs[1][-1]).sum())
    work, dirty = outs[0][:-1], outs[0][-1]
    del outs

    def restore():
        for w, x in zip(work, written):
            w.copy_(x)
        dirty.copy_(flags)

    ms = time_restored(lambda: run("cuda", work, dirty), restore, flush)
    if split:
        extra = {**split_ms(lambda: run("cuda", work, dirty), restore, flush),
                 **(extra or {})}
    if old is not None:
        ms, old_ms = paired_restored((lambda: run("cuda", work, dirty),
                                      lambda: old(work, dirty)), restore, flush)
        old_split = split_ms(lambda: old(work, dirty), restore, flush)
        extra = {**(extra or {}), "old_ms": old_ms,
                 "old_device_ms": old_split["device_ms"],
                 "old_latency_ms": old_split["latency_ms"]}
    plain_ms = time_restored(lambda: run("ref", work, dirty), restore, flush,
                             reps=plain_reps, warm=1 if plain_reps > 1 else 0)
    library_ms = None if library is None else time_ms(library, flush=flush)
    bound_ms, bound_by = bound(bytes_moved(flagged), operations)
    entries.append({
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": launches[module],
        "max_abs_err": err, "max_abs_diff": err, "equal": True,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "in_place": True, "rows_flagged": flagged, **(extra or {})})
    say(f"[kernels] {name}: in place {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; "
        f"{flagged} rows flagged; equal, flags included"
        + "".join(f"; {k} {v:.4f}" if isinstance(v, float) else f"; {k} {v}"
                  for k, v in (extra or {}).items()))


def catch_up_library(front, back, flags, table_flags):
    """What the catch-up computes, one PyTorch call per leaf (for
    ``library_ms``): ``torch.where(flags, front, back)`` on each leaf copied
    by row (the flags broadcast over its other dims), on the src table's
    keys and vals by its slot groups' flags, and a copy of the scalars."""
    rows, groups = flags.bool(), table_flags.bool().view(-1, 1)
    group = front[4].numel() // table_flags.numel()
    return [f.clone() if i == 6 else
            torch.where(groups, f.view(-1, group), b.view(-1, group)).view(-1)
            if i in (4, 5) else
            torch.where(rows.view((-1,) + (1,) * (f.dim() - 1)), f, b)
            for i, (f, b) in enumerate(zip(front, back))]


def paired_restored(fns, restore, flush, reps=10, warm=2):
    """Medians of each of ``fns`` by CUDA events, called in turns (one of
    each per round), each call after ``restore()`` and a rewrite of
    ``flush`` (neither timed)."""
    times = [[] for _ in fns]
    for rep in range(warm + reps):
        for fn, out in zip(fns, times):
            restore()
            flush.add_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if rep >= warm:
                out.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def catch_up_entry(entries, launches, name, front, back, flags, table_flags,
                   extra=None):
    """The catch-up at a path's shapes as the learner launches it: bound
    once (``ops.bind_copy_dirty_rows``), one ``ops.copy_bound_rows`` a
    call, from ``front`` into copies of ``back`` (9-tuples, ``epoch._copied``)
    by copies of the row and table flags.  Held equal to the plain version
    (both flags cleared alike) and to the library calls; timed beside the
    plain version, the library calls and the whole-table kernel it replaced
    (``old_*``, in turns with the kernel: same call, same inputs), its
    device time and idle-device latency split for both.  The bound counts
    what the flags of this run ask for: the flags read, each flagged row
    and table group read and written, the scalars."""
    from repro_torch.kernels import ops
    outs = []
    for impl in ("cuda", "ref"):
        work = [x.clone() for x in back]
        fl = (flags.clone(), table_flags.clone())
        if impl == "cuda":
            ops.copy_bound_rows(ops.bind_copy_dirty_rows(front, work, *fl))
        else:
            ops.copy_dirty_rows(front, work, *fl, impl="ref")
        outs.append(work + list(fl))
        torch.cuda.synchronize()
    err = compare(f"{name} (bound, both flags)", *outs)
    compare(f"{name} (the library calls)",
            catch_up_library(front, back, flags, table_flags), outs[0][:-2])
    work, fl = outs[0][:-2], outs[0][-2:]
    del outs

    def restore():
        for w, x in zip(work, back):
            w.copy_(x)
        fl[0].copy_(flags)
        fl[1].copy_(table_flags)

    bound_args = ops.bind_copy_dirty_rows(front, work, *fl)
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    n, c = front[0].shape
    h = front[7].shape[1]
    t, k = front[4].numel(), front[6].numel()

    def old():   # the whole-table kernel, as the learner launched it before
        baseline_call("mcq_base_copy_dirty_rows",
                      *(x.data_ptr() for x in front[:7]),
                      *(x.data_ptr() for x in work[:7]),
                      front[7].data_ptr(), front[8].data_ptr(),
                      work[7].data_ptr(), work[8].data_ptr(),
                      fl[0].data_ptr(), n, c, t, k, h)

    ms, old_ms = paired_restored(
        (lambda: ops.copy_bound_rows(bound_args), old), restore, flush)
    new_split = split_ms(lambda: ops.copy_bound_rows(bound_args), restore,
                         flush)
    old_split = split_ms(old, restore, flush)
    plain_ms = time_restored(
        lambda: ops.copy_dirty_rows(front, work, *fl, impl="ref"), restore,
        flush, reps=3, warm=1)
    library_ms = time_ms(lambda: catch_up_library(front, back, flags,
                                                  table_flags),
                         flush=flush)
    rows, groups = int(flags.sum()), int(table_flags.sum())   # on the card
    group = t // table_flags.numel()
    bound_ms, bound_by = bound(
        n + table_flags.numel() + rows + groups
        + rows * 8 * (3 * c + 1 + 2 * h) + groups * 16 * group + 8 * k, 0)
    entries.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/copy_rows.cu",
        "replaces": "none: the back-buffer learner's catch-up",
        "launches": launches["copy_dirty_rows"],
        "max_abs_err": err, "max_abs_diff": err, "equal": True,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        **new_split, "old_ms": old_ms, "old_device_ms": old_split["device_ms"],
        "old_latency_ms": old_split["latency_ms"], "in_place": True,
        "bound_once": True, "rows": n, "rows_flagged": rows,
        "table_slots": t, "table_groups_flagged": groups,
        "slots_per_group": group, **(extra or {})})
    say(f"[kernels] {name}: bound {ms:.4f} ms (device {new_split['device_ms']:.4f}, "
        f"idle-device latency {new_split['latency_ms']:.4f}); the whole-table "
        f"kernel it replaced {old_ms:.4f} ms (device "
        f"{old_split['device_ms']:.4f}, latency {old_split['latency_ms']:.4f}); "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); {rows} of {n} rows and {groups} of "
        f"{table_flags.numel()} table groups flagged; equal, flags included")


def learner_catch_up_entry(entries, launches, name, learner, extra=None):
    """``catch_up_entry`` on a ``BackBufferLearner``'s own tensors: from
    its front into copies of its back, by copies of the flags its last
    write left (what its next write copies)."""
    from repro_torch.core import epoch
    front, back = (epoch._copied(epoch._chain(x))
                   for x in (learner._front, learner._back))
    catch_up_entry(entries, launches, name, front, back,
                   learner._dirty.view(-1).clone(),
                   learner._table_dirty.view(-1).clone(), extra)


def time_restored(fn, restore, flush, reps=10, warm=2):
    """Median milliseconds of ``fn()`` by CUDA events, each call after
    ``restore()`` and a rewrite of ``flush`` (neither timed): for a call
    that writes into its inputs."""
    times = []
    for rep in range(warm + reps):
        restore()
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if rep >= warm:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phases_ms(fn, restore, prefix, reps=3):
    """Device milliseconds per call of each kernel whose name starts with
    ``prefix``, by torch.profiler over ``reps`` calls of ``fn()`` (each after
    ``restore()``); empty when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            restore()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                not ev.key.startswith(prefix):
            continue
        device_us = getattr(ev, "self_device_time_total", None)
        if device_us is None:
            device_us = ev.self_cuda_time_total
        out[ev.key.split("(")[0]] = device_us / 1e3 / reps
    return out


def slow_path_entry(entries, launches, flush, name, cfg, table, slabs,
                    counters, items, sequential, row_hashes=()):
    """The new-edge pass at a path's shapes: the in-place form as
    ``update_batch_`` launches it (src table, dst_slab, cnt, tot, counters
    and the ``row_hashes`` (dh_keys, dh_vals) if given its own, flags set)
    held equal, flags included, to the plain mirror of its decomposition
    (and, where ``sequential``, to the sequential plain version); timed in
    place and by launch, and the functional wrapper (its copies included)
    beside it; the bound of each from the bytes it must move."""
    from repro_torch.core.hashtable import flag_count, hash_u32
    from repro_torch.kernels import ops, ref
    n, c = slabs.cnt.shape
    h = table.keys.shape[0]
    probes = cfg.max_probes
    p_src, _, _, p_mask = items
    length, n_active = p_src.numel(), int(p_mask.sum())
    state = (table.keys, table.vals, slabs.dst, slabs.cnt, slabs.tot,
             slabs.order, counters, *row_hashes)
    written = (0, 1, 2, 3, 4, 6, 7, 8)[:6 + len(row_hashes)]

    def dh(args):   # the row hashes among a call's arguments, as keywords
        return dict(zip(("dh_keys", "dh_vals"), args[7:]))

    def on_copies(fn):
        """``fn(work, dirty, table_dirty)`` on copies; the written tensors
        and both flags."""
        work = [x.clone() if i in written else x for i, x in enumerate(state)]
        dirty = torch.zeros(n, dtype=torch.uint8, device="cuda")
        table_dirty = torch.zeros(flag_count(h), dtype=torch.uint8,
                                  device="cuda")
        fn(work, dirty, table_dirty)
        torch.cuda.synchronize()
        return [work[i] for i in written] + [table_dirty, dirty]

    got = on_copies(lambda w, d, t: ops.slow_path_(
        *w[:7], *items, max_probes=probes, dirty=d, impl="cuda",
        table_dirty=t, **dh(w)))
    t0 = time.perf_counter()
    want = on_copies(lambda w, d, t: ref.slow_path_rows_ref_(
        *w[:7], *items, probes, d, *w[7:], table_dirty=t))
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare(f"{name} (both flags)", got, want)
    sequential_ms = None
    if sequential:
        t0 = time.perf_counter()
        compare(f"{name} vs the sequential plain version", got, on_copies(
            lambda w, d, t: ref.slow_path_ref_(*w[:7], *items, probes, d,
                                               *w[7:], table_dirty=t)))
        sequential_ms = (time.perf_counter() - t0) * 1e3
    rows = int(want[-1].sum())       # every row an item is applied to
    counts = want[5] - counters
    # each row-hash lane the pass changed is read and written (key, value)
    lanes = sum(int((x != y).sum()) for x, y in zip(want[6:8], row_hashes))
    del got, want

    # bytes: every item's active flag, an active item's src/dst/w and its
    # probe window up to where it stops, each touched row's dst/cnt/tot/order
    # tail read once and its flag set, two writes per active item
    p = torch.arange(probes, device="cuda")
    act_src = p_src[p_mask]
    win = table.keys[((hash_u32(act_src) & (h - 1)).unsqueeze(1) + p) & (h - 1)]
    hit = (win == act_src.unsqueeze(1)) | (win == -1)
    stop = torch.where(hit.any(dim=1), hit.int().argmax(dim=1), probes - 1) + 1
    probed = int(stop.sum())
    del win, hit, stop
    work_bytes = 4 * (length + 3 * n_active + 2 * probed + rows * (2 * c + 3)
                      + 2 * n_active + 8 + 4 * lanes) + rows
    copy_bytes = 4 * 2 * (2 * h + 2 * n * c + n + 4
                          + sum(x.numel() for x in row_hashes))
    operations = n_active * (3 * probes + 4 * c)

    originals = [state[i] for i in written]
    work = [x.clone() for x in originals]
    dirty = torch.zeros(n, dtype=torch.uint8, device="cuda")
    table_dirty = torch.zeros(flag_count(h), dtype=torch.uint8, device="cuda")

    def restore_all():
        for dst_t, src_t in zip(work, originals):
            dst_t.copy_(src_t)
        dirty.zero_()
        table_dirty.zero_()

    def kernel():
        ops.slow_path_(*work[:5], slabs.order, work[5], *items,
                       max_probes=probes, dirty=dirty, impl="cuda",
                       table_dirty=table_dirty,
                       **dict(zip(("dh_keys", "dh_vals"), work[6:])))

    ms = time_restored(kernel, restore_all, flush)
    phases = kernel_phases_ms(kernel, restore_all, "mcq_sp_")
    del work
    functional_ms = time_ms(lambda: ops.slow_path(
        *state[:7], *items, max_probes=probes, impl="cuda", **dh(state)),
        flush=flush)
    bound_ms, bound_by = bound(work_bytes, operations)
    functional_bound_ms, _ = bound(work_bytes + copy_bytes, operations)
    entries.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slow_path.cu",
        "replaces": "src/repro/core/mcprioq.py:311"
        + (" (row-hash edits :356-358)" if row_hashes else ""),
        "launches": launches["slow_path"],
        "max_abs_err": err, "max_abs_diff": err, "equal": True,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "in_place": True, "functional_ms": functional_ms,
        "functional_bound_ms": functional_bound_ms,
        "phases_ms": phases, "sequential_plain_ms": sequential_ms,
        "active_items": n_active, "items": length, "rows_touched": rows,
        "row_hash_lanes_changed": lanes})
    say(f"[kernels] {name}: {n_active} active of {length} items on {rows} rows "
        f"(counters moved by {counts.tolist()}); in place {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); the functional wrapper (copies "
        f"included) {functional_ms:.4f} ms, bound {functional_bound_ms:.4f} ms; "
        f"by launch (profiler, ms per call) "
        + (", ".join(f"{k} {v:.4f}" for k, v in phases.items()) or "not measured")
        + f"; plain mirror {plain_ms:.1f} ms"
        + ("" if sequential_ms is None
           else f", sequential plain version {sequential_ms:.1f} ms (once)")
        + "; equal, flags included")


# ---------------------------------------------------------------------------
# phase 4: the dst-hash path at full width
# ---------------------------------------------------------------------------

HASH_KERNELS = MAIN_KERNELS + ("dh_rebuild",)


def hash_against_scan(state, cfg, traffic, calls=8):
    """An update's device time, the dst hash against the row scan, on the
    same batches, printed: a copy of the warmed state is driven with the
    hash off (its row hashes then go stale; it is dropped after).  Both see
    the same batches, so their slabs stay equal (checked); by kernel name
    (torch.profiler) and by events with a spin kernel queued ahead."""
    from repro_torch import core
    scan_cfg = dataclasses.replace(cfg, use_dst_hash=False)
    scan = core.private_copy(state)
    batches = [traffic.batch(BATCH) for _ in range(3 * calls)]
    result = {}
    for label, st, c in (("hash", state, cfg), ("scan", scan, scan_cfg)):
        it = iter(batches[:calls])
        by_kernel = kernel_phases_ms(
            lambda: core.update_batch_(st, *next(it), cfg=c), lambda: None, "",
            reps=calls)
        result[label] = (sum(by_kernel.values()) if by_kernel else None,
                         by_kernel)
    for a, b in zip(state.slabs, scan.slabs):
        if not torch.equal(a, b):
            raise AssertionError("hash vs scan: the two paths' slabs differ")
    it = {label: iter(batches[calls:]) for label in ("hash", "scan")}
    for label, st, c in (("hash", state, cfg), ("scan", scan, scan_cfg)):
        device_ms, idle_ms = call_ms(
            lambda: core.update_batch_(st, *next(it[label]), cfg=c),
            reps=calls)
        result[label] += (device_ms, idle_ms)
    del scan
    for label, (total, by_kernel, device_ms, idle_ms) in result.items():
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        say(f"[hash] update_batch_ with the {label}: device {device_ms:.4f} ms "
            f"per call by events (latency on an idle device {idle_ms:.4f} ms), "
            f"{'not measured' if total is None else f'{total:.4f} ms'} by "
            f"kernel (torch.profiler, {calls} calls): "
            + ", ".join(f"{k[:60]} {v:.4f}" for k, v in top))


def phase_hash(seed, warm_batches, rounds):
    """The main path with the per-row dst hash: the same chain and traffic
    as phase main, ``use_dst_hash=True`` (H = 512 lanes per row)."""
    from repro_torch import core
    from repro_torch.core.epoch import BackBufferLearner, EpochStore
    cfg = core.MCConfig(num_rows=NUM_NODES, capacity=128, sort_passes=1,
                        decay_block_rows=1024, max_new_per_batch=8192,
                        use_dst_hash=True, impl="auto")
    traffic = Traffic(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = core.init(cfg)
    say(f"[hash] {cfg}")
    say(f"[hash] row hashes {cfg.num_rows} x {cfg.resolved_dst_table_size()} "
        f"lanes; state {torch.cuda.memory_allocated() / 2**30:.2f} GiB resident; "
        f"rebuild threshold {cfg.dh_rebuild_threshold()} tombstones")
    decay_threshold = 64
    t0 = time.perf_counter()
    for batch in range(warm_batches):
        src, dst = traffic.batch(BATCH)
        core.update_batch_(state, src, dst, cfg=cfg)
        core.maybe_decay_(state, cfg=cfg, total_threshold=decay_threshold)
        if batch % 10 == 9:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    say(f"[hash] warm-up: {warm_batches} batches of {BATCH} with maybe_decay_ "
        f"in {time.perf_counter() - t0:.1f} s; counters "
        f"{core.counter_stats(state)}")

    side = core.private_copy(state)
    for i in range(SIDE_ROUNDS):
        src, dst = traffic.batch(BATCH)
        if core.update_batch_(state, src, dst, cfg=cfg) is not state:
            raise AssertionError("update_batch_ returned another state")
        side = core.update_batch(side, src, dst, cfg=cfg)
        equal_states(f"hash round {i}: update_batch_ vs update_batch", state, side)
        core.maybe_decay_(state, cfg=cfg, total_threshold=decay_threshold)
        side = core.maybe_decay(side, cfg=cfg, total_threshold=decay_threshold)
        equal_states(f"hash round {i}: maybe_decay_ vs maybe_decay", state, side)
    core.decay_(state, cfg=cfg)
    equal_states("hash: decay_ vs decay", state, core.decay(side, cfg=cfg))
    del side
    say(f"[hash] {SIDE_ROUNDS} rounds of update_batch_ + maybe_decay_ and one "
        f"decay_ equal to the functional calls on a side copy: all 18 leaves, "
        f"row hashes included; peak device memory with the side copy "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    times = {}
    with launch_window("hash", HASH_KERNELS) as launches:
        for _ in range(rounds):
            src, dst = traffic.batch(BATCH)
            q = traffic.srcs(QUERIES)
            timed(times, "update_batch_", no_sync, core.update_batch_, state,
                  src, dst, cfg=cfg)
            answers = timed(times, "query_threshold", no_sync,
                            core.query_threshold, state, q, 0.9, cfg=cfg,
                            max_items=16)
            timed(times, "query_topk", no_sync, core.query_topk, state, q,
                  cfg=cfg, k=8)
            timed(times, "maybe_decay_", no_sync, core.maybe_decay_, state,
                  cfg=cfg, total_threshold=decay_threshold)
        timed(times, "decay_", no_sync, core.decay_, state, cfg=cfg)
    torch.cuda.synchronize()
    med = {k: statistics.median(s.elapsed_time(e) for s, e in v)
           for k, v in times.items()}
    say(f"[hash] {rounds} rounds; median ms per call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    say(f"[hash] observe {BATCH / med['update_batch_'] * 1e3:.0f} edges/s "
        f"(device time by CUDA events, no synchronisation inside the calls); "
        f"peak device memory over the rounds "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for key, fn in (
            ("decay_", lambda: core.decay_(state, cfg=cfg)),
            ("maybe_decay_[no fire]", lambda: core.maybe_decay_(
                state, cfg=cfg, total_threshold=2 ** 31 - 1))):
        device_ms, idle_ms = call_ms(lambda fn=fn: no_sync(fn))
        say(f"[hash] {key}: device {device_ms:.4f} ms, latency on an idle "
            f"device {idle_ms:.4f} ms (medians of 20, in turns)")
    batches = iter([traffic.batch(BATCH) for _ in range(3)])
    no_state_copies("update_batch_ (dst hash)", lambda: core.update_batch_(
        state, *next(batches), cfg=cfg), cfg.num_rows)
    no_state_copies("decay_ (dst hash, rolling)",
                    lambda: core.decay_(state, cfg=cfg), cfg.num_rows)
    no_state_copies("maybe_decay_ (dst hash)", lambda: core.maybe_decay_(
        state, cfg=cfg, total_threshold=decay_threshold), cfg.num_rows)
    say("[hash] update_batch_, the queries, maybe_decay_ and decay_ ran under "
        "set_sync_debug_mode('error'): no device->host synchronisation")

    # the back-buffer learner over the dst-hash chain: its catch-up copies
    # the flagged rows' row hashes too
    store = EpochStore(state)
    learner = BackBufferLearner(store)
    learned = []
    with launch_window("hash/learner", ("copy_dirty_rows",)) as learner_launches:
        for _ in range(4):
            src, dst = traffic.batch(BATCH)
            learned.append(timed(times, "learner write", no_sync, learner.write,
                                 lambda s, dirty, table_dirty, src=src,
                                 dst=dst: core.maybe_decay_(
                                     core.update_batch_(
                                         s, src, dst, cfg=cfg, dirty=dirty,
                                         table_dirty=table_dirty),
                                     cfg=cfg, total_threshold=decay_threshold,
                                     dirty=dirty)))
    launches["copy_dirty_rows"] = learner_launches["copy_dirty_rows"]
    torch.cuda.synchronize()
    say(f"[hash] learner writes (catch-up, update_batch_, maybe_decay_): "
        f"median {statistics.median(s.elapsed_time(e) for s, e in times['learner write']):.3f} ms")
    state = learned[-1]
    del store, learner, learned

    hash_against_scan(state, cfg, traffic)

    # a rebuild of the warmed table, forced by a threshold of 0 tombstones:
    # decided on the device inside decay_, then every invariant holds
    force = dataclasses.replace(cfg, dh_rebuild_fraction=0.0)
    before = core.maintenance_stats(state)
    if before["dh_tombstones"] <= 0:
        raise AssertionError(f"no tombstone to force a rebuild with: {before}")
    rebuild = {}
    timed(rebuild, "decay_", no_sync, core.decay_, state, cfg=force)
    torch.cuda.synchronize()
    after = core.maintenance_stats(state)
    if after["dh_rebuilds"] != before["dh_rebuilds"] + 1 or after["dh_tombstones"]:
        raise AssertionError(f"the forced rebuild did not run: {before} -> {after}")
    rebuild_ms = rebuild["decay_"][0][0].elapsed_time(rebuild["decay_"][0][1])
    inv = core.check_invariants(state, cfg)
    say(f"[hash] forced rebuild of {cfg.num_rows} row hashes inside decay_ "
        f"(threshold 0 tombstones, {before['dh_tombstones']} held): "
        f"{rebuild_ms:.3f} ms by events, rebuilds {before['dh_rebuilds']} -> "
        f"{after['dh_rebuilds']}; invariants {inv}")
    if not all(v for k, v in inv.items() if k != "sorted_fraction"):
        raise AssertionError(f"invariants violated after the rebuild: {inv}")
    dk, pk, nn = answers
    if dk.shape != (QUERIES, 16) or not bool(torch.isfinite(pk).all()) \
            or not bool((nn > 0).any()):
        raise AssertionError("dst-hash path: query answers are wrong")
    say(f"[hash] counters {core.counter_stats(state)}; maintenance "
        f"{core.maintenance_stats(state)}")
    return state, cfg, traffic, launches


def dh_probe_work(rows, keys_q, dh_keys, max_probes):
    """What a stacked probe of ``keys_q`` in tables ``rows`` must read:
    ``(lanes whose key is read + found lanes' values)``, as
    :func:`probe_work` counts a flat one."""
    from repro_torch.core import hashtable as ht
    h = dh_keys.shape[1]
    p = torch.arange(max_probes, device="cuda")
    idx = ((ht.hash_u32(keys_q) & (h - 1)).unsqueeze(1) + p) & (h - 1)
    win = dh_keys[rows.clamp(min=0).long().unsqueeze(1), idx]
    key_p = ht.first_true(win == keys_q.unsqueeze(1), dim=1)[0]
    empty_p = ht.first_true(win == -1, dim=1)[0]
    live = (keys_q != -1) & (rows >= 0)
    probed = torch.where(live, torch.minimum(key_p, empty_p)
                         .clamp(max=max_probes - 1) + 1, 0)
    return int(probed.sum()) + int((live & (key_p < empty_p)).sum())


def hash_path_kernels(state, cfg, src, dst, launches):
    """The dst-hash path's device code at that path's shapes and data, each
    against its plain version (equal) and timed beside its bound: the
    stacked probe as the classify calls it (beside the row scan it
    replaces), the new-edge pass with the row-hash edits, the rolling decay
    with the repair (beside the same call without it), the rebuild of
    every row hash, and the learner's catch-up with the row hashes."""
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import slab as sl
    from repro_torch.kernels import ops
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    n, c = cfg.num_rows, cfg.capacity
    h = cfg.resolved_dst_table_size()
    slabs, table = state.slabs, state.src_table
    dh = dict(dh_keys=state.dh_keys, dh_vals=state.dh_vals)
    entries = []

    src, dst, w, m = mc._batch_inputs(state, src, dst, None, None)
    u_src, u_dst, u_w, u_act, u_pos = mc._aggregate_batch(src, dst, w, m)
    rows0, found_src0 = mc.lookup_rows(state, u_src, cfg)
    _, found_d0 = mc._find_slots(state, rows0, u_dst, cfg)
    fast = u_act & found_src0 & found_d0
    p_src, p_dst, p_w, p_mask, _ = mc._take_new_prefix(
        u_src, u_dst, u_w, u_pos, u_act & ~fast, cfg.resolved_max_new(BATCH))

    # the classify: the stacked probe against the scan's gather of the rows
    items = rows0.numel()
    slot_reads = dh_probe_work(rows0, u_dst, state.dh_keys, cfg.max_probes)
    rows64 = rows0.long()
    scan_ms = time_ms(lambda: sl.find_slot(slabs, rows64, u_dst), flush=flush)
    scan_bound, _ = bound(4 * (items * c + 3 * items), 2 * items * c)
    kernel_entry(entries, launches, flush, "probe_find[hash, dh_find]",
                 "probe_find", "probe.cu", "src/repro/kernels/probe.py:105",
                 lambda impl: ops.dh_find(rows0, u_dst, state.dh_keys,
                                          state.dh_vals,
                                          max_probes=cfg.max_probes, impl=impl),
                 bytes_moved=4 * (2 * items + slot_reads) + 5 * items,
                 operations=12 * items + 3 * slot_reads,
                 extra=dict(batch=items, table=f"{n}x{h}", scan_ms=scan_ms,
                            scan_bound_ms=scan_bound))

    # the new-edge pass with the row-hash edits, as update_batch_ runs it
    counters = torch.stack([state.n_rows, state.dropped_rows,
                            state.dropped_probes, state.evictions])
    slow_path_entry(entries, launches, flush, "slow_path[hash]", cfg, table,
                    slabs, counters, (p_src, p_dst, p_w, p_mask),
                    sequential=False, row_hashes=(state.dh_keys, state.dh_vals))

    # the rolling decay with the repair, as decay_ launches it, and the same
    # call without the row hashes beside it
    r = cfg.resolved_decay_rows()
    tombs = state.dh_tombstones.reshape(())
    rolling = (slabs.cnt, slabs.dst, slabs.order, slabs.tot, state.decay_cursor)
    saved = [x.clone() for x in rolling]

    def restore():
        for x, y in zip(rolling, saved):
            x.copy_(y)

    plain_decay_ms = time_restored(lambda: ops.decay_sort_rolling_(
        *rolling, block_rows=r), restore, flush)
    restore()
    del saved
    cur = int(state.decay_cursor) % -(-n // r)
    row0 = min(cur * r, n - r)
    block_keys = state.dh_keys[row0:row0 + r]
    block_vals = state.dh_vals[row0:row0 + r].clamp(0, c - 1).long()
    halved = slabs.cnt[row0:row0 + r] >> 1
    dead = int(((block_keys >= 0)
                & (torch.gather(halved, 1, block_vals) == 0)).sum())
    del block_vals, halved
    inplace_entry(entries, launches, flush, "decay_sort[hash, rolling + repair]",
                  "decay_sort", "decay_sort.cu", "src/repro/core/mcprioq.py:580",
                  lambda impl, work, dirty: ops.decay_sort_rolling_(
                      *work[:5], block_rows=r, dirty=dirty,
                      dh_keys=work[5], dh_vals=state.dh_vals,
                      tombstones=work[6], impl=impl),
                  (*rolling, state.dh_keys, tombs),
                  bytes_moved=lambda flagged: 4 * (6 * r * c + r + 2 + 2 * r * h
                                                   + dead + 1) + flagged,
                  operations=r * (c * 8 + 3 * h),
                  extra=dict(rows=r, dead_lanes=dead,
                             without_repair_ms=plain_decay_ms))
    say(f"[kernels] the repair adds {entries[-1]['ms'] - plain_decay_ms:.4f} ms "
        f"to the rolling decay of {r} rows ({plain_decay_ms:.4f} ms without "
        f"the row hashes, {dead} lanes tombstoned)")

    # the rebuild of every row hash, forced (threshold -1): cnt/dst read,
    # the row hashes written, every row flagged
    live = int((slabs.cnt > 0).sum())
    inplace_entry(entries, launches, flush, "dh_rebuild[hash]", "dh_rebuild",
                  "dh_rebuild.cu", "src/repro/core/mcprioq.py:196",
                  lambda impl, work, dirty: ops.dh_rebuild_(
                      slabs.cnt, slabs.dst, *work, threshold=-1,
                      max_probes=cfg.max_probes, dirty=dirty, impl=impl),
                  (state.dh_keys, state.dh_vals,
                   torch.stack([state.dh_rebuilds, state.dh_tombstones])),
                  bytes_moved=lambda flagged: 8 * n * c + 8 * n * h + flagged + 8,
                  operations=4 * n * h + 16 * live, plain_reps=1,
                  extra=dict(rows=n, live_slots=live))

    # the learner's catch-up: a back buffer one update behind the front
    from repro_torch.core import epoch
    from repro_torch.core import hashtable as ht
    back = mc.private_copy(state)
    dirty = torch.zeros(n, dtype=torch.uint8, device="cuda")
    table_dirty = torch.zeros(ht.flag_count(table.keys.numel()),
                              dtype=torch.uint8, device="cuda")
    mc.update_batch_(state, src, dst, cfg=cfg, dirty=dirty,
                     table_dirty=table_dirty)
    catch_up_entry(entries, launches, "copy_dirty_rows[hash]",
                   epoch._copied(state), epoch._copied(back), dirty,
                   table_dirty)
    del back
    return entries


# ---------------------------------------------------------------------------
# phase 5: the speculative drafter at full width
# ---------------------------------------------------------------------------

VOCAB = 152_064          # qwen2-7b's vocabulary (src/repro/configs/qwen2_7b.py)
DRAFT_SEQS, DRAFT_LEN = 64, 1_025   # 65,536 transitions per observe
WINDOWS = 4_096
DRAFTER_KERNELS = ("draft_walk", "probe_find", "slab_update", "oddeven",
                   "slow_path", "cdf_query_fused", "decay_sort",
                   "copy_dirty_rows")


class TokenTraffic:
    """``token_stream``'s structure made on the device: a hidden table of 4
    successors per token, 20 % uniform noise, every sequence starting from a
    uniform token."""

    def __init__(self, seed, vocab=VOCAB):
        self.vocab = vocab
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(seed)
        self.succ = randint(self.gen, 0, vocab, (vocab, 4))

    def batch(self, seqs=DRAFT_SEQS, length=DRAFT_LEN):
        """int32[seqs, length].  Token t is ``succ[token t-1, pick]`` or
        noise; the recurrence is solved by parallel sweeps over all
        positions — a position is final once every position back to its
        run's noise token is — repeated until a sweep changes nothing."""
        pick = randint(self.gen, 0, 4, (seqs, length)).long()
        noise = randint(self.gen, 0, self.vocab, (seqs, length))
        fixed = torch.rand((seqs, length), generator=self.gen, device="cuda") < 0.2
        fixed[:, 0] = True
        toks = noise
        while True:
            for _ in range(8):
                prev = torch.roll(toks, 1, dims=1).long()
                toks = torch.where(fixed, noise, self.succ[prev, pick])
            prev = torch.roll(toks, 1, dims=1).long()
            if torch.equal(toks, torch.where(fixed, noise, self.succ[prev, pick])):
                return toks

    def contexts(self, toks, n=WINDOWS, width=8, unknown=0.06):
        """n contexts of ``width`` tokens cut from ``toks`` at random places;
        a share ``unknown`` of them replaced by uniform tokens (contexts the
        chain never saw)."""
        seq = randint(self.gen, 0, toks.shape[0], (n,)).long()
        end = randint(self.gen, width, toks.shape[1] + 1, (n,)).long()
        span = torch.arange(-width, 0, device="cuda")
        ctx = toks[seq.unsqueeze(1), end.unsqueeze(1) + span]
        fresh = torch.rand(n, generator=self.gen, device="cuda") < unknown
        return torch.where(fresh.unsqueeze(1),
                           randint(self.gen, 0, self.vocab, (n, width)), ctx)


def walk_work(window, toks, oks, keys, max_probes, lanes):
    """What a draft walk over these inputs must read: (table slots probed,
    steps whose probe found the context, steps run, dependent round trips
    per step, most of one sequence).  A sequence runs its steps up to and
    including the one that fails.  With ``lanes`` lanes a step takes
    ceil(probed / lanes) trips, then one (order head with the row) where the
    context was found; a sequence takes one more to load its window."""
    from repro_torch.core import hashtable as ht
    b, k = toks.shape
    order = window.shape[1]
    t_size = keys.shape[0]
    seq = torch.cat([window, toks], dim=1)
    run = (oks.to(torch.int64).sum(dim=1) + 1).clamp(max=k)
    p = torch.arange(max_probes, device="cuda")
    probed = found_steps = 0
    trips = torch.ones(b, dtype=torch.int64, device="cuda")
    for s in range(k):
        live = run > s
        src = ht.ctx_window_hash(seq[:, s:s + order])
        win = keys[((ht.hash_u32(src) & (t_size - 1)).unsqueeze(1) + p) & (t_size - 1)]
        key_p = ht.first_true(win == src.unsqueeze(1), dim=1)[0]
        empty_p = ht.first_true(win == -1, dim=1)[0]
        stop = torch.minimum(key_p, empty_p).clamp(max=max_probes - 1) + 1
        found = live & (key_p < empty_p)
        probed += int(stop[live].sum())
        found_steps += int(found.sum())
        trips += torch.where(live, (stop + lanes - 1) // lanes + found, 0)
    steps = int(run.sum())
    return probed, found_steps, steps, float(trips.sum() - b) / steps, int(trips.max())


def drafts_in_loop(learn, traffic, current, cfg, rounds, busy_cycles=4_000_000):
    """Device ms of ``draft`` at k = 4 and k = 8 where a server meets it:
    each round one learner step (its odd-even pass sweeps the table through
    the L2), then the reader's two drafts, k = 4 first, on the state it
    published.  A spin kernel queued ahead of the drafts keeps the host's
    launch time out of the events.  Returns ``{k: [ms per round]}``."""
    from repro_torch.core import speculative as spec
    times = {4: [], 8: []}
    for _ in range(rounds):
        toks = traffic.batch()
        learn(toks)
        ctx = traffic.contexts(toks)
        state = current()
        torch.cuda._sleep(busy_cycles)
        for k, out in times.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            spec.draft(state, ctx, cfg=cfg, k=k)
            end.record()
            out.append((start, end))
        torch.cuda.synchronize()
    return {k: [s.elapsed_time(e) for s, e in v] for k, v in times.items()}


def phase_drafter(seed, warm_batches, rounds, profile=False):
    from repro_torch import core
    from repro_torch.core import speculative as spec
    from repro_torch.core.epoch import BackBufferLearner, EpochStore
    from repro_torch.kernels import ops, walk
    cfg = spec.NGramConfig(order=2, decay_threshold=1 << 18, mc=core.MCConfig(
        num_rows=2 ** 20, capacity=64, sort_passes=1, decay_block_rows=1024,
        max_new_per_batch=8192))
    traffic = TokenTraffic(seed + 7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    store = EpochStore(spec.init(cfg))
    learner = BackBufferLearner(store)
    say(f"[drafter] {cfg}")
    say(f"[drafter] table {cfg.mc.resolved_table_size()} slots; the front and "
        f"the back state {(torch.cuda.memory_allocated() - base) / 2**30:.2f} "
        f"GiB resident; vocabulary {VOCAB}, {DRAFT_SEQS} x {DRAFT_LEN} tokens "
        f"per observe, {WINDOWS} windows per draft")
    times = {}

    def learn(toks, ncfg=cfg, key="observe"):
        """One learner write through the back buffer: catch the back up,
        observe_ + maintain_ into it, publish it."""
        def step(st, dirty, table_dirty):
            timed(times, key, spec.observe_, st, toks, cfg=ncfg, dirty=dirty,
                  table_dirty=table_dirty)
            timed(times, f"maintain_{'' if ncfg is cfg else '[decay]'}",
                  spec.maintain_, st, cfg=ncfg, dirty=dirty)
            return st
        return timed(times, f"learner write{'' if key == 'observe' else f'[{key}]'}",
                     no_sync, learner.write, step)

    def read(ctx):
        """The reader loop; returns the state it read and its answers."""
        snap = learner.acquire()
        try:
            out = {k: no_sync(spec.draft, snap.state, ctx, cfg=cfg, k=k)
                   for k in (4, 8)}
            out["candidates"] = no_sync(spec.candidates, snap.state, ctx, 0.9,
                                        cfg=cfg, max_items=8)
            return snap.state, out
        finally:
            store.release(snap)

    def current():
        snap = learner.acquire()
        store.release(snap)
        return snap.state

    # warm-up: the learner loop for a fixed number of batches
    t0 = time.perf_counter()
    gen_s = 0.0
    for batch in range(warm_batches):
        g0 = time.perf_counter()
        toks = traffic.batch()
        gen_s += time.perf_counter() - g0
        learn(toks, key="warm-up")
        if batch % 5 == 4:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    stats = core.counter_stats(current().chain)
    say(f"[drafter] warm-up: {warm_batches} observe batches in "
        f"{time.perf_counter() - t0:.1f} s ({gen_s:.1f} s of it making "
        f"tokens); counters {stats}")
    # the states the learner publishes against a functional learner's
    func = spec.DrafterState(chain=core.private_copy(current().chain))
    for i in range(SIDE_ROUNDS):
        toks = traffic.batch()
        func = spec.maintain(spec.observe(func, toks, cfg=cfg), cfg=cfg)
        learn(toks, key="check")
        equal_states(f"drafter round {i}: back-buffer learner vs functional "
                     f"learner", current().chain, func.chain)
    del func
    say(f"[drafter] {SIDE_ROUNDS} learner writes through the back buffer "
        f"(copy_dirty_rows + observe_ + maintain_) published the states of a "
        f"functional learner: all 18 leaves equal")
    times.clear()
    torch.cuda.reset_peak_memory_stats()

    # measured rounds: learner and reader, launch counts around them
    # a threshold low enough that the rolling decay fires, as the main
    # phase's 64 does (lower if no row has grown past 64 yet)
    low = dataclasses.replace(cfg, decay_threshold=min(
        64, int(current().chain.slabs.tot.max()) - 1))
    with launch_window("drafter", DRAFTER_KERNELS) as launches:
        for _ in range(rounds):
            toks = traffic.batch()
            learn(toks)
            ctx = traffic.contexts(toks)
            state, out = read(ctx)
        pre, decay_toks = current(), traffic.batch()
        steps0 = core.maintenance_stats(pre.chain)["decay_steps"]
        learn(decay_toks, ncfg=low)          # the rolling decay fires once
    steps1 = core.maintenance_stats(current().chain)["decay_steps"]
    if steps1 <= steps0:
        raise AssertionError("drafter: the low-threshold maintain did not decay")
    med = {k: statistics.median(s.elapsed_time(e) for s, e in v)
           for k, v in times.items()}
    say(f"[drafter] {rounds} rounds; median ms per call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))
    ok4 = out[4][1]
    trans = DRAFT_SEQS * (DRAFT_LEN - 1)
    # the reader's calls on the snapshot it read, device time and latency
    calls = {f"draft k={k}": functools.partial(spec.draft, state, ctx, cfg=cfg,
                                               k=k) for k in (4, 8)}
    calls["candidates"] = functools.partial(spec.candidates, state, ctx, 0.9,
                                            cfg=cfg, max_items=8)
    reader = {key: call_ms(lambda fn=fn: no_sync(fn)) for key, fn in calls.items()}
    say("[drafter] reader calls, device / latency on an idle device (medians "
        "of 20): " + ", ".join(f"{k} {d:.4f} / {i:.4f} ms"
                               for k, (d, i) in reader.items()))
    say(f"[drafter] observe {trans / med['observe'] * 1e3:.0f} transitions/s "
        f"(device time, 20 rounds); draft k=4 "
        f"{WINDOWS * 4 / reader['draft k=4'][0] * 1e3:.0f} drafted tokens/s, "
        f"k=8 {WINDOWS * 8 / reader['draft k=8'][0] * 1e3:.0f}; candidates "
        f"{WINDOWS / reader['candidates'][0] * 1e3:.0f} queries/s (device "
        f"time); at the idle-device latency: "
        f"{WINDOWS * 4 / reader['draft k=4'][1] * 1e3:.0f}, "
        f"{WINDOWS * 8 / reader['draft k=8'][1] * 1e3:.0f} tokens/s and "
        f"{WINDOWS / reader['candidates'][1] * 1e3:.0f} queries/s")
    say(f"[drafter] ok drafts: {float(ok4.float().mean()):.4f} of k=4 steps, "
        f"{float(out[8][1].float().mean()):.4f} of k=8 steps; first step ok "
        f"for {float(ok4[:, 0].float().mean()):.4f} of windows; rolling decay "
        f"{steps0} -> {steps1} blocks; peak device memory over the rounds "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"[drafter] counters {core.counter_stats(current().chain)}")

    # what came out is right: the decaying learner step again with the plain
    # versions (every state leaf equal), the candidates of the plain versions,
    # draft == draft_reference at full width, and the candidates well formed
    plain = dataclasses.replace(low, mc=dataclasses.replace(low.mc, impl="ref"))
    equal_states("drafter: observe + decaying maintain at full width",
                 current().chain, spec.maintain(spec.observe(
                     pre, decay_toks, cfg=plain), cfg=plain).chain)
    del pre
    compare("drafter: candidates impl=cuda vs ref at full width",
            out["candidates"], spec.candidates(state, ctx, 0.9, cfg=plain,
                                               max_items=8))
    for k in (4, 8):
        compare(f"draft k={k} vs draft_reference", out[k],
                spec.draft_reference(state, ctx, cfg=cfg, k=k))
    dk, pk, nn = out["candidates"]
    if dk.shape != (WINDOWS, 8) or nn.shape != (WINDOWS,):
        raise AssertionError("candidates have the wrong shape")
    if not bool(torch.isfinite(pk).all()) or not bool(((pk >= 0) & (pk <= 1)).all()):
        raise AssertionError("candidate probabilities are not in [0, 1]")
    if not bool(ok4[:, 0].any()):
        raise AssertionError("drafter: no window drafted a token")
    say(f"[drafter] the decaying learner step's 18 state leaves and the "
        f"candidates equal to the plain versions'; draft == draft_reference "
        f"token for token at k=4 and k=8; candidates: {int((nn > 0).sum())}/"
        f"{WINDOWS} known, mean n_needed {float(nn[nn > 0].float().mean()):.2f}")

    # every kernel of the path at the drafter's shapes, against its plain
    # version: the chain's kernels on one more observe batch and the
    # candidates' srcs, then the walk on the last round's windows
    toks = traffic.batch()
    src = spec.context_ids(toks, cfg.order)[:, :-1].reshape(-1)
    window = ctx[:, -cfg.order:]
    entries = path_shape_kernels(
        current().chain, cfg.mc, src, toks[:, 1:].reshape(-1),
        spec.context_ids(window, cfg.order)[:, -1].contiguous(), launches,
        path="drafter", reads=((0.9, 8),), unfused=False)
    del toks, src
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    launch_floor = time_ms(lambda: torch.cuda._sleep(0), flush=flush)
    # the drafts inside the learner loop, where a server meets them
    in_loop = drafts_in_loop(learn, traffic, current, cfg, rounds)
    say(f"[drafter] draft device ms inside the learner loop ({rounds} rounds, "
        f"medians): " + ", ".join(f"k={k} {statistics.median(t):.4f}"
                                  for k, t in in_loop.items()))
    # a learner write copies no state: the back is caught up by rows
    batches = iter([traffic.batch() for _ in range(3)])
    no_state_copies("learner write (copy_dirty_rows + observe_ + maintain_)",
                    lambda: learn(next(batches)), cfg.mc.num_rows)
    # copy_dirty_rows at the drafter's shapes, on the flags the last write
    # left: what the next write copies
    learner_catch_up_entry(entries, launches, "copy_dirty_rows[drafter]",
                           learner)
    # the walk on the windows of the last round, over the state published now
    state = current()
    chain = state.chain
    keys = chain.src_table.keys
    walk_args = (window, keys, chain.src_table.vals, chain.slabs.cnt,
                 chain.slabs.dst, chain.slabs.order[:, 0])
    for k in (4, 8):
        toks_k, ok_k = spec.draft(state, ctx, cfg=cfg, k=k)
        probed, found_steps, steps, trips, trips_max = walk_work(
            window, toks_k, ok_k, keys, cfg.mc.max_probes, walk.LANES)
        kernel_entry(
            entries, launches, flush, f"draft_walk[k={k}]", "draft_walk",
            "walk.cu", "src/repro/kernels/walk.py:123",
            lambda impl, k=k: ops.draft_walk(
                *walk_args, k=k, max_probes=cfg.mc.max_probes, impl=impl),
            # window in; per step the probed slots, then value, order head,
            # cnt and dst where the context was found; toks + ok out
            bytes_moved=4 * (window.numel() + probed + 4 * found_steps)
            + WINDOWS * k * 5,
            operations=steps * (14 * cfg.order + 10) + 3 * probed,
            extra=dict(launch_floor_ms=launch_floor, lanes=walk.LANES,
                       in_loop_ms=statistics.median(in_loop[k]),
                       trips_per_step=trips, trips_max=trips_max))

    if profile:
        pool = []
        for _ in range(5):       # tokens made before the window
            toks = traffic.batch()
            pool.append((toks, traffic.contexts(toks)))
        rounds_left = iter(pool)

        def drafter_round():
            toks, ctx = next(rounds_left)
            learn(toks)
            read(ctx)
        profile_window("drafter round (observe + maintain + 2 drafts + "
                       "candidates)", drafter_round)
    return entries


# ---------------------------------------------------------------------------
# phase 6: the sharded chain, four logical shards on the card
# ---------------------------------------------------------------------------

SHARDS = 4
SHARD_NODES = int(0.95 * SHARDS * NUM_NODES)   # no shard runs out of rows
TOP_N = 16
# sh.topn on the card: the window kernel, then topn_merge.cu's merge (or
# the merge in the window kernel's last block) and its srcs' pass
TOPN_KERNELS = ("topn_windows", "topn_merge")
SHARDED_KERNELS = MAIN_KERNELS + TOPN_KERNELS


def sharded_config():
    from repro_torch import core
    from repro_torch.core import sharded as sh
    return sh.ShardedConfig(base=core.MCConfig(
        num_rows=NUM_NODES, capacity=128, sort_passes=1, decay_block_rows=1024,
        max_new_per_batch=8192), num_shards=SHARDS, bucket_factor=2.0)


def host_topn(state, n):
    """The global top-n by the plain definition, sorted on the host: every
    shard's live edges listed in (shard, row, priority position) order,
    ``cnt / max(tot, 1)``, a stable descending sort, the first n, labelled
    with their src from the shard's src table; and the live edges beyond
    each shard's n best (what the merge is not shown).  Only the edges at
    or above the n-th probability leave the device."""
    slabs = state.slabs
    s, rows, c = slabs.cnt.shape
    c_ord = torch.gather(slabs.cnt, 2, slabs.order.long())
    d_ord = torch.gather(slabs.dst, 2, slabs.order.long())
    prob = torch.where(c_ord > 0, c_ord.float() / slabs.tot.clamp(min=1)
                       .float().unsqueeze(2), 0.0).view(-1)
    live = (c_ord > 0).view(s, -1).sum(dim=1).tolist()
    floor = torch.topk(prob, n).values[-1]
    idx = torch.nonzero(prob >= floor).view(-1)
    p = prob[idx].cpu().numpy()
    d = d_ord.view(-1)[idx].cpu().numpy()
    idx = idx.cpu().numpy()
    keep = np.argsort(-p, kind="stable")[:n]
    shard, row = idx[keep] // (rows * c), idx[keep] // c % rows
    keys, vals = (x.cpu().numpy() for x in state.src_table)
    src_of_row = np.full((s, rows), -1, dtype=np.int64)
    for i in range(s):
        valid = (keys[i] >= 0) & (vals[i] >= 0)
        src_of_row[i, vals[i][valid]] = keys[i][valid]
    srcs = src_of_row[shard, row]
    live_top = p[keep] > 0
    # each shard exposes its n best live edges to the merge
    return (np.where(live_top, srcs, -1), np.where(live_top, d[keep], -1),
            np.where(live_top, p[keep], 0.0).astype(np.float32),
            sum(live) - sum(min(n, x) for x in live))


def phase_sharded(seed, warm_batches, rounds):
    from repro_torch import core
    from repro_torch.core import sharded as sh
    scfg = sharded_config()
    cfg = scfg.base
    batch, queries = SHARDS * BATCH, SHARDS * QUERIES
    traffic = Traffic(seed + 11, nodes=SHARD_NODES)
    w = torch.ones(batch, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    state = sh.init_sharded(scfg)
    say(f"[sharded] {scfg}")
    say(f"[sharded] {SHARDS} shards x {cfg.num_rows} rows x {cfg.capacity} slots "
        f"(src tables of {cfg.resolved_table_size()} slots): "
        f"{(torch.cuda.memory_allocated() - base_mem) / 2**30:.2f} GiB resident; "
        f"src uniform over {SHARD_NODES} nodes; {batch} transitions per update "
        f"({BATCH} per sender slice, bucket capacity "
        f"{scfg.bucket_capacity(BATCH)}), {queries} srcs per query")

    t0 = time.perf_counter()
    warm_sharded(state, scfg, traffic, w, warm_batches)
    stats = core.counter_stats(state)
    say(f"[sharded] warm-up: {warm_batches} global batches of {batch} in "
        f"{time.perf_counter() - t0:.1f} s; rows per shard "
        f"{state.n_rows.tolist()}; counters {stats}")
    offered = warm_batches * batch
    say(f"[sharded] warm-up losses of {offered} transitions offered: "
        f"{stats['dropped_probes']} new pairs dropped on a full probe window "
        f"(dropped_probes, queue C 11: "
        f"{100 * stats['dropped_probes'] / offered:.3f} %), "
        f"{stats['deferred_new']} new pairs past the per-shard prefix "
        f"(deferred_new: {100 * stats['deferred_new'] / offered:.3f} %), "
        f"{stats['route_dropped']} routing drops")
    if stats["dropped_rows"] or stats["route_dropped"]:
        raise AssertionError(f"sharded warm-up dropped rows or routes: {stats}")

    # the owner calls against the functional callables on a side copy
    decay_threshold = 64
    update = sh.make_update_fn(scfg)
    maintain = sh.make_maintain_fn(scfg, decay_threshold)
    side = core.private_copy(state)
    for i in range(SIDE_ROUNDS):
        src, dst = traffic.batch(batch)
        if sh.update_(state, src, dst, w, scfg=scfg) is not state:
            raise AssertionError("sharded update_ returned another state")
        side = update(side, src, dst, w)
        equal_states(f"sharded round {i}: update_ vs make_update_fn", state, side)
        sh.maintain_(state, scfg=scfg, total_threshold=decay_threshold)
        side = maintain(side)
        equal_states(f"sharded round {i}: maintain_ vs make_maintain_fn",
                     state, side)
    sh.decay_(state, scfg=scfg)
    equal_states("sharded: decay_ vs make_decay_fn", state,
                 sh.make_decay_fn(scfg)(side))
    del side
    say(f"[sharded] {SIDE_ROUNDS} rounds of update_ + maintain_ and one decay_ "
        f"(owner calls, in place) equal to the functional callables on a side "
        f"copy: all 18 stacked leaves after every call; peak device memory "
        f"with the side copy {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()

    # measured rounds, launch counts around exactly them
    times = {}
    totals = []       # the row totals' sum around every update_ (no sync)
    lost0 = core.counter_stats(state)
    with launch_window("sharded", SHARDED_KERNELS) as launches:
        for _ in range(rounds):
            src, dst = traffic.batch(batch)
            q = traffic.srcs(queries)
            totals.append(state.slabs.tot.sum(dtype=torch.int64))
            timed(times, "update_", no_sync, sh.update_, state, src, dst, w,
                  scfg=scfg)
            totals.append(state.slabs.tot.sum(dtype=torch.int64))
            answers = timed(times, "query", no_sync, sh.query, state, q, 0.9,
                            16, scfg=scfg)
            timed(times, "maintain_", no_sync, sh.maintain_, state, scfg=scfg,
                  total_threshold=decay_threshold)
            top = timed(times, "topn", no_sync, sh.topn, state, TOP_N,
                        scfg=scfg)
    med = {k: statistics.median(s.elapsed_time(e) for s, e in v)
           for k, v in times.items()}
    say(f"[sharded] {rounds} rounds; median ms per call (events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    lost = {k: v - lost0[k] for k, v in core.counter_stats(state).items()
            if k in ("dropped_probes", "deferred_new", "route_dropped",
                     "dropped_rows")}
    grown = torch.stack(totals).view(rounds, 2)
    recorded = int((grown[:, 1] - grown[:, 0]).sum())   # weights are all 1
    say(f"[sharded] observe {batch / med['update_'] * 1e3:.0f} transitions/s "
        f"offered, {recorded / rounds / med['update_'] * 1e3:.0f} recorded "
        f"({recorded} of {rounds * batch} = {100 * recorded / (rounds * batch):.2f} "
        f"% added to the row totals; lost over the rounds: {lost}); query "
        f"{queries / med['query'] * 1e3:.0f} srcs/s (no synchronisation inside "
        f"the calls)")
    say(f"[sharded] peak device memory over the rounds "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("[sharded] update_, query, maintain_ and topn ran under "
        "set_sync_debug_mode('error'): no device->host synchronisation")
    src, dst = traffic.batch(batch)
    q = traffic.srcs(queries)
    for key, fn in (
            ("update_", lambda: sh.update_(state, src, dst, w, scfg=scfg)),
            ("query", lambda: sh.query(state, q, 0.9, 16, scfg=scfg)),
            ("maintain_", lambda: sh.maintain_(
                state, scfg=scfg, total_threshold=decay_threshold)),
            ("topn", lambda: sh.topn(state, TOP_N, scfg=scfg))):
        device_ms, idle_ms = call_ms(lambda fn=fn: no_sync(fn))
        say(f"[sharded] {key}: device {device_ms:.4f} ms, latency on an idle "
            f"device {idle_ms:.4f} ms, device busy {100 * device_ms / idle_ms:.1f} "
            f"% of it (medians of 20, in turns)")
    batches = iter([traffic.batch(batch) for _ in range(3)])
    no_state_copies("sharded update_", lambda: sh.update_(
        state, *next(batches), w, scfg=scfg), cfg.num_rows)
    no_state_copies("sharded maintain_", lambda: sh.maintain_(
        state, scfg=scfg, total_threshold=decay_threshold), cfg.num_rows)

    queue_c11_checks(state, scfg, traffic, w)

    # a skewed round: its drops are what the host predicts
    src, dst = skewed_batch(traffic, scfg, SHARD_NODES)
    predicted = sh.predict_route_overflow(scfg, src.cpu().numpy())
    before = state.route_dropped.clone()
    sh.update_(state, src, dst, w, scfg=scfg)
    got = (state.route_dropped - before).tolist()
    want = predicted.reshape(SHARDS, -1).sum(axis=1).tolist()
    say(f"[sharded] skewed round: route_dropped per sender {got}, "
        f"predict_route_overflow {want}")
    if got != want or want[0] <= 0:
        raise AssertionError(f"skewed round: route_dropped {got} != predicted {want}")

    # what came out is right: the global top-n against the plain definition,
    # the answers' shapes and values, every shard's invariants
    m_src, m_dst, m_p, dropped = sh.topn(state, TOP_N, scfg=scfg)
    h_src, h_dst, h_p, h_dropped = host_topn(state, TOP_N)
    if not (np.array_equal(m_src.cpu().numpy(), h_src)
            and np.array_equal(m_dst.cpu().numpy(), h_dst)
            and np.array_equal(m_p.cpu().numpy(), h_p)
            and int(dropped) == h_dropped):
        raise AssertionError(f"global top-{TOP_N} differs from the host's sort: "
                             f"{m_p.tolist()} vs {h_p.tolist()}")
    say(f"[sharded] global top-{TOP_N} equal to a stable descending sort of every "
        f"shard's live edges on the host: probs {m_p.tolist()}; {int(dropped)} "
        f"live edges not exposed")
    for s in range(SHARDS):
        inv = core.check_invariants(sh.shard_state(state, s), cfg)
        if not all(v for key, v in inv.items() if key != "sorted_fraction"):
            raise AssertionError(f"shard {s}: invariants violated: {inv}")
    dk, pk, nn, qdrop = answers
    if dk.shape != (queries, 16) or nn.shape != (queries,) or qdrop.shape != (SHARDS,):
        raise AssertionError("sharded query answers have the wrong shape")
    if not bool(torch.isfinite(pk).all()) or not bool(((pk >= 0) & (pk <= 1)).all()):
        raise AssertionError("sharded probabilities are not finite values in [0, 1]")
    known = nn > 0
    say(f"[sharded] queries: {int(known.sum())}/{queries} srcs known, mean "
        f"n_needed {float(nn[known].float().mean()):.2f}, routing drops "
        f"{qdrop.tolist()}; top-n of the last round {top[2].tolist()[:4]}...; "
        f"counters {core.counter_stats(state)}")
    return state, scfg, traffic, launches


def skewed_batch(traffic, scfg, nodes):
    """A global batch whose sender 0 sends 60 % of its slice to shard 0
    (fair share 1/S, bucket capacity 2/S): ``(src, dst)``."""
    cands = randint(traffic.gen, 0, nodes, (1 << 18,))
    hot = cands[scfg.resolved_ownership().owner_of(cands) == 0]
    src, _ = traffic.batch(scfg.num_shards * BATCH)
    k = int(0.6 * BATCH)
    src[:k] = hot[randint(traffic.gen, 0, hot.numel(), (k,)).long()]
    return src, traffic.dsts(src)


def queue_c11_checks(state, scfg, traffic, w):
    """Queue C 11 on the card.  (1) Under the default map at S = 4 a src's
    owner is bits 8-9 of ``hash_u32(src)``, the same bits as its home slot
    in its shard's src table: every src that shard s holds has a home slot
    whose bits 8-9 are s, a quarter of the table.  (2) The dropped probes of
    one more update are the new (src, dst) pairs whose src that table still
    lacks after it: a pair past the per-shard prefix is deferred instead,
    so ``absent - deferred <= dropped_probes <= absent`` on every shard,
    equal where nothing was deferred."""
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    from repro_torch.core.hashtable import EMPTY, hash_u32
    s = scfg.num_shards
    if scfg.ownership is not None or 256 % s:
        raise AssertionError("queue C 11's check reads the default map")
    keys = state.src_table.keys
    home = hash_u32(keys) & (keys.shape[1] - 1)
    shard = torch.arange(s, device=keys.device).unsqueeze(1)
    held = int((keys >= 0).sum())
    off = int(((keys >= 0) & ((home >> 8) % s != shard)).sum())
    if off:
        raise AssertionError(f"queue C 11: {off} srcs of {held} sit on a home "
                             f"slot outside their shard's quarter")
    src, dst = traffic.batch(s * BATCH)
    (rsrc, rdst), *_ = sh._route(scfg, state, src, (dst,))
    before = torch.stack([state.dropped_probes, state.deferred_new])
    sh.update_(state, src, dst, w, scfg=scfg)
    dropped, deferred = (torch.stack([state.dropped_probes, state.deferred_new])
                         - before).tolist()
    absent = []
    for r in range(s):
        _, found = mc.lookup_rows(sh.shard_state(state, r), rsrc[r], scfg.base)
        pairs = (rsrc[r].long() << 32) | (rdst[r].long() & 0xFFFFFFFF)
        absent.append(torch.unique(
            pairs[(rsrc[r] != EMPTY) & ~found]).numel())
    say(f"[sharded] queue C 11: all {held} srcs held sit on home slots whose "
        f"bits 8-9 name their shard (a quarter of each table); one more "
        f"update: new pairs whose src is absent after it {absent}, "
        f"dropped_probes {dropped}, deferred_new {deferred}")
    for r in range(s):
        if not absent[r] - deferred[r] <= dropped[r] <= absent[r]:
            raise AssertionError(
                f"queue C 11, shard {r}: dropped_probes {dropped[r]} is not "
                f"the absent srcs' new pairs {absent[r]} (deferred "
                f"{deferred[r]})")


def sharded_path_kernels(state, scfg, traffic, launches):
    """Shard 0's kernels at the shapes the sharded path gives them (its
    receiver's bucket slots of one more global batch and of the queries),
    against their plain versions and timed; then the top-n's kernels
    (:func:`topn_path_kernels`)."""
    from repro_torch.core import sharded as sh
    batch, queries = SHARDS * BATCH, SHARDS * QUERIES
    src, dst = traffic.batch(batch)
    (rsrc, rdst), *_ = sh._route(scfg, state, src, (dst,))
    (rq,), *_ = sh._route(scfg, state, traffic.srcs(queries))
    entries = path_shape_kernels(sh.shard_state(state, 0), scfg.base, rsrc[0],
                                 rdst[0], rq[0], launches, path="sharded",
                                 reads=((0.9, 16),), unfused=False)
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    launch_floor = time_ms(lambda: torch.cuda._sleep(0), flush=flush)
    entries += topn_path_kernels(state, scfg, launches, flush, launch_floor)
    return entries


def topn_path_kernels(state, scfg, launches, flush, launch_floor):
    """``sh.topn`` on the card at phase sharded's shape: the window kernel
    (``topn_windows``) and the merge of its block lists (``topn_merge``)
    against their plain mirrors, timed beside their bounds, the launch
    floor and a library call; the whole read; the plain path's sort; and, by torch.profiler, the device kernels of a call: no
    sort and no op over the ``[S, N, k]`` windows."""
    from repro_torch.core import sharded as sh
    from repro_torch.kernels import ops, ref, topn_merge, topn_windows as tw
    slabs = state.slabs
    s, rows, c = slabs.cnt.shape
    k = min(TOP_N, c)
    args = (slabs.cnt, slabs.order, slabs.tot, slabs.dst, *state.src_table)
    blocks = tw.blocks_for(slabs.cnt, TOP_N)
    got = ops.topn_windows(*args, n=TOP_N)
    winners = int((got[2] > 0).sum())
    compare("sh.topn == ops.topn_windows", sh.topn(state, TOP_N, scfg=scfg), got)
    compare("ops.topn_windows: the kernels vs their plain mirror", got,
            ops.topn_windows(*args, n=TOP_N, impl="ref"))
    prob, _, _ = sh._windows(state, TOP_N)     # the plain path's windows
    read_ms = time_ms(lambda: tw.topn_windows_cuda(*args, n=TOP_N), reps=20,
                      flush=flush)
    entries = []
    kernel_entry(
        entries, launches, flush, "topn_windows[sharded]", "topn_windows",
        "topn_windows.cu", "src/repro/core/sharded.py:270 (_topn_local's "
        "window, lax.top_k and live count; no Pallas kernel)",
        lambda impl: (tw.window_lists_cuda(*args[:3], n=TOP_N)
                      if impl == "cuda" else ref.topn_window_lists_ref(
                          *args[:3], TOP_N, blocks)),
        # every row's counts, k order heads and total read once; the block
        # lists and the counts written
        bytes_moved=4 * s * rows * (c + k + 1) + 8 * s * blocks * TOP_N
        + 16 * s, operations=s * rows * (c + 2 * k), plain_reps=2,
        library=lambda: torch.topk(prob, TOP_N, dim=1),
        extra=dict(read_ms=read_ms, blocks_per_shard=blocks,
                   lists=s * blocks, live_winners=winners,
                   library_is="torch.topk over the precomputed [S, N*k] "
                              "windows (values; no tie order)"))
    select_ms = time_ms(lambda: sh._top_k(prob, TOP_N), flush=flush)
    say(f"[sharded] the plain path's selection over {tuple(prob.shape)} window "
        f"entries (a stable descending sort): {select_ms:.4f} ms (median of "
        f"10 by events, L2 flushed); ops.topn_windows (the window kernel, "
        f"the merge, the srcs' pass) {read_ms:.4f} ms ({blocks} blocks a "
        f"shard)")
    del prob

    # the merge alone on the plain path's S lists of n (its shape before
    # this path read block lists)
    plain_lists = sh.topn_lists(state, TOP_N, scfg=scfg)[:3]
    compare("topn_merge on the plain path's lists",
            ops.topn_merge(*plain_lists, n=TOP_N),
            ops.topn_merge(*plain_lists, n=TOP_N, impl="ref"))
    merge_s_ms = time_ms(lambda: ops.topn_merge(*plain_lists, n=TOP_N),
                         reps=20, flush=flush)
    del plain_lists

    lists, counts = tw.window_lists_cuda(*args[:3], n=TOP_N)
    compare("topn_windows lists vs their mirror", (lists, counts),
            ref.topn_window_lists_ref(*args[:3], TOP_N, blocks))
    live_lists = int((lists > 0).sum())

    def library():
        """torch.sort of the lists' keys: on these lists, whose keys are
        unique, the merge's picks (values only, no labels)."""
        return torch.sort(lists.view(-1), descending=True).values[:TOP_N]

    kernel_entry(
        entries, launches, flush, "topn_merge[sharded]", "topn_merge",
        "topn_merge.cu", "src/repro/kernels/ref.py:185",
        lambda impl: (topn_merge.merge_windows_cuda(
            lists, counts, args[1], *args[3:], n=TOP_N, blocks=blocks)
            if impl == "cuda" else ref.topn_merge_windows_ref(
                lists, counts, args[1], *args[3:], TOP_N, blocks)),
        # the flat merge over the block lists: every list's first head
        # and the head each step advances to, the live winners' keys,
        # order heads and dsts, the counts; the srcs' pass reads every
        # table lane's value once and the winners' keys; the n outputs
        # and the count written
        bytes_moved=4 * (s * blocks + TOP_N) + 16 * winners + 16 * s
        + 4 * state.src_table.vals.numel() + 12 * TOP_N + 4,
        operations=4 * TOP_N * s * blocks, library=library,
        extra=dict(launch_floor_ms=launch_floor, lists=s * blocks,
                   length=TOP_N, merge_of_s_lists_ms=merge_s_ms,
                   live_list_entries=live_lists,
                   live_winners=winners,
                   form="the merge's own launch after topn_windows, then "
                        "the srcs' pass over the src tables"))
    del lists, counts
    topn_profile(state, scfg, (s, rows, k))
    return entries


def topn_profile(state, scfg, windows, calls=10):
    """Device kernels of ``sh.topn`` by torch.profiler (with shapes):
    fails on a sort or top-k kernel, on any op over the ``[S, N, k]``
    windows (flattened or not), or if the window kernel does not run;
    prints the kernels and the launches per call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import sharded as sh
    from repro_torch.kernels import topn_merge, topn_windows
    s, rows, k = windows
    shapes = {(s, rows, k), (s, rows * k)}
    torch.cuda.synchronize()
    before = topn_windows.launches, topn_merge.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(calls):
            sh.topn(state, TOP_N, scfg=scfg)
        torch.cuda.synchronize()
    per_call = [(topn_windows.launches - before[0]) / calls,
                (topn_merge.launches - before[1]) / calls]
    events = prof.events()
    kernels = [ev.name for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    sorts = sorted({n for n in kernels
                    if any(w in n.lower() for w in ("sort", "topk", "radix"))})
    over = sorted({ev.name for ev in events
                   if ev.device_type == torch.autograd.DeviceType.CPU
                   and any(tuple(x) in shapes for x in (ev.input_shapes or ())
                           if isinstance(x, (list, tuple)))})
    say(f"[sharded] sh.topn on the card: {len(kernels) / calls:g} device "
        f"kernels per call by torch.profiler over {calls} calls "
        f"{sorted(set(n[:50] for n in kernels))}; launches per call: "
        f"topn_windows {per_call[0]:g}, topn_merge {per_call[1]:g}; sort "
        f"kernels {sorts}; ops over the {sorted(shapes)} windows {over}")
    if sorts or over or not any("mcq_topn_windows" in n for n in kernels):
        raise AssertionError(f"sh.topn on the card ran a sort {sorts} or an "
                             f"op over the windows {over}, or no window "
                             f"kernel")


# ---------------------------------------------------------------------------
# phase 6a: the sharded chain one shard a process rank
# ---------------------------------------------------------------------------

RANKS_CALLS = 20       # (a): rounds held to the one-card chain after each call
RANKS_WARM = 32        # (b), (c): warm-up rounds, then RANKS_CALLS timed ones
RANKS_LIMIT_S = 180    # a rank group ends within this, or is killed
RANKS_THRESHOLD = 64   # maintain_'s total threshold, as phase sharded's


def ranks_config(world):
    """Phase sharded's configuration at ``world`` shards, one a rank."""
    return dataclasses.replace(sharded_config(), num_shards=world)


def rank_launches(acc, fn, *args, **kw):
    """``fn(*args, **kw)``, its kernel launches added to ``acc``: the rank
    path's launches apart from the one-card chain's it is held to."""
    mods = kernel_modules()
    before = {name: mod.launches for name, mod in mods.items()}
    out = fn(*args, **kw)
    for name, mod in mods.items():
        acc[name] = acc.get(name, 0) + mod.launches - before[name]
    return out


def rank_nccl_one(rank, world, rdv, out_dir, go, seed, root):
    """Phase ranks (a), in a spawned process: one NCCL rank (world 1,
    S = 1) beside the one-card stacked chain at S = 1 on the same card and
    batches; after every ``update_`` and ``maintain_`` the 18 leaves
    equal, every query and top-16 equal; the rank's owner calls, query and
    top-n under ``set_sync_debug_mode('error')``; then the ranked serving
    engine (:func:`rank_engine`, its files under ``root``)."""
    from repro_torch.core import sharded as sh
    from repro_torch.sharding.ranks import init_ranks
    torch.set_num_threads(1)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    group = init_ranks(rank, world, backend="nccl", init_method=rdv,
                       device="cuda:0", timeout=60.0)
    scfg = ranks_config(1)
    mine, one = sh.init_sharded(scfg, ranks=group), sh.init_sharded(scfg)
    traffic = Traffic(seed + 29)
    w = torch.ones(BATCH, dtype=torch.int32, device="cuda")
    group.psum(torch.zeros(1, device="cuda"))   # the communicator's first use
    torch.cuda.synchronize()
    ready_at = time.time()
    go.wait(RANKS_LIMIT_S)
    t0 = time.perf_counter()
    launches = {}
    # round 0 unguarded (first uses: the ownership table on the card ...),
    # then RANKS_CALLS rounds under the sync guard
    for i in range(RANKS_CALLS + 1):
        guard = no_sync if i else (lambda fn, *a, **kw: fn(*a, **kw))
        src, dst = traffic.batch(BATCH)
        q = traffic.srcs(QUERIES)
        rank_launches(launches, guard, sh.update_, mine, src, dst, w,
                      scfg=scfg, ranks=group)
        sh.update_(one, src, dst, w, scfg=scfg)
        equal_states(f"[ranks] (a) round {i}: update_ on the rank vs one card",
                     mine, one)
        got = rank_launches(launches, guard, sh.query, mine, q, 0.9, 16,
                            scfg=scfg, ranks=group)
        compare(f"[ranks] (a) round {i}: query", got,
                sh.query(one, q, 0.9, 16, scfg=scfg))
        rank_launches(launches, guard, sh.maintain_, mine, scfg=scfg,
                      total_threshold=RANKS_THRESHOLD, ranks=group)
        sh.maintain_(one, scfg=scfg, total_threshold=RANKS_THRESHOLD)
        equal_states(f"[ranks] (a) round {i}: maintain_", mine, one)
        got = rank_launches(launches, guard, sh.topn, mine, TOP_N, scfg=scfg,
                            ranks=group)
        compare(f"[ranks] (a) round {i}: top-{TOP_N}", got,
                sh.topn(one, TOP_N, scfg=scfg))
    torch.cuda.synchronize()
    result = {"launches": launches, "ready_at": ready_at,
              "rounds_s": time.perf_counter() - t0,
              "n_rows": int(mine.n_rows.sum()),
              "route_dropped": int(mine.route_dropped.sum())}
    del mine, one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result.update(rank_engine(group, seed, root))
    result["engine_s"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))
    rank_exit(group)


def rank_group_run(rank, world, rdv, out_dir, go, backend, seed, root):
    """Phase ranks (b) and (c), in a spawned process: rank ``rank`` of
    ``world`` at phase sharded's width and traffic (this rank's slice of
    every global batch, drawn from the seed as every rank draws it),
    ``RANKS_WARM`` rounds of ``update_`` + query + ``maintain_`` + top-16,
    ``RANKS_CALLS`` timed ones (events, and events around each collective
    for its share of the call),
    a skewed round, ``gather_sharded`` to rank 0 with each rank's answers
    and top-16s; rank 0 then replays the same batches through the one-card
    stacked chain on its card and holds the gathered state, the answers,
    the top-16s and each rank's ``route_dropped`` (also against
    ``predict_route_overflow``) equal to it; then the ranked serving engine
    (:func:`rank_engine`, its files under ``root``)."""
    from repro_torch import convert
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    from repro_torch.sharding.ranks import init_ranks
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    device = torch.device("cuda", 0 if backend == "gloo" else rank)
    group = init_ranks(rank, world, backend=backend, init_method=rdv,
                       device=device, timeout=60.0)
    guard = no_sync if backend == "nccl" else (lambda fn, *a, **kw: fn(*a, **kw))
    comm = []    # the event pairs around the collectives of one call

    def clocked(fn):   # events around a collective, on the call's stream
        def call(x):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = fn(x)
            pair[1].record()
            comm.append(pair)
            return out
        return call

    scfg = ranks_config(world)
    nodes = int(0.95 * world * NUM_NODES)
    traffic = Traffic(seed + 31, nodes=nodes)
    state = sh.init_sharded(scfg, ranks=group)
    w = torch.ones(BATCH, dtype=torch.int32, device=device)
    scfg.resolved_ownership().table(device)      # built before any guard
    group.psum(torch.zeros(1, device=device))    # the group's first use
    torch.cuda.synchronize()
    ready_at = time.time()
    go.wait(RANKS_LIMIT_S)
    group.psum(torch.zeros(1, device=device))    # every rank past the wait
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = slice(rank * BATCH, (rank + 1) * BATCH)
    qpart = slice(rank * QUERIES, (rank + 1) * QUERIES)
    times, kept = {}, []
    for i in range(RANKS_WARM + RANKS_CALLS):
        src, dst = traffic.batch(world * BATCH)
        q = traffic.srcs(world * QUERIES)
        if i == RANKS_WARM:      # the timed rounds: launches and clocks
            torch.cuda.synchronize()
            for mod in kernel_modules().values():
                mod.launches = 0
            all_to_all, all_gather = group.all_to_all, group.all_gather
            group.all_to_all = clocked(all_to_all)
            group.all_gather = clocked(all_gather)
        calls = (
            ("update_", lambda: guard(sh.update_, state, src[part], dst[part],
                                      w, scfg=scfg, ranks=group)),
            ("query", lambda: guard(sh.query, state, q[qpart], 0.9, 16,
                                    scfg=scfg, ranks=group)),
            ("maintain_", lambda: guard(sh.maintain_, state, scfg=scfg,
                                        total_threshold=RANKS_THRESHOLD,
                                        ranks=group)),
            ("topn", lambda: guard(sh.topn, state, TOP_N, scfg=scfg,
                                   ranks=group)))
        outs = {}
        for key, fn in calls:
            if i < RANKS_WARM:
                outs[key] = fn()
                continue
            comm.clear()
            outs[key] = timed(times, key, fn)
            times.setdefault(key + "/comm", []).append(list(comm))
        if i >= RANKS_WARM:
            kept.append((outs["query"], outs["topn"]))
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    med = {}
    for key in ("update_", "query", "maintain_", "topn"):
        ms = [s.elapsed_time(e) for s, e in times[key]]
        share = [sum(s.elapsed_time(e) for s, e in pairs) / m
                 for pairs, m in zip(times[key + "/comm"], ms)]
        med[key] = (statistics.median(ms), statistics.median(share))
    src, dst = skewed_batch(traffic, scfg, nodes)   # as phase sharded's
    sh.update_(state, src[part], dst[part], w, scfg=scfg, ranks=group)
    answers = [torch.stack([a[x] for a, _ in kept]) for x in range(4)]
    tops = [torch.stack([t[x] for _, t in kept]) for x in range(4)]
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    got = [group.gather(x.unsqueeze(0)) for x in answers + tops]
    gathered = convert.gather_sharded(state, group, 0)
    counters = mc.counter_stats(state, group)
    result = {"launches": launches, "ready_at": ready_at,
              "rounds_s": rounds_s,
              "gather_s": time.perf_counter() - t0 - rounds_s,
              "median_ms": {k: v[0] for k, v in med.items()},
              "comm_share": {k: v[1] for k, v in med.items()},
              "counters": counters}
    del state, answers, tops, kept
    group.all_to_all, group.all_gather = all_to_all, all_gather
    if rank == 0:
        result["checks"] = rank_group_check(scfg, seed, world, gathered, got,
                                            counters)
    del gathered, got
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result.update(rank_engine(group, seed, root))
    result["engine_s"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))
    rank_exit(group)


def rank_exit(group):
    """End a rank's process once every rank is past its last collective,
    without tearing the groups down: a rank's teardown racing its peers'
    exits can abort the process (SIGABRT) after its work is done."""
    group.agree([0])
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def rank_group_check(scfg, seed, world, gathered, got, counters):
    """Rank 0's side of (b)/(c): the one-card stacked chain on the same
    batches, replayed here; ``gathered`` (the group's state on the CPU) and
    ``got`` (each rank's answers and top-16s, stacked by rank) equal to
    it, each rank's ``route_dropped`` equal to ``predict_route_overflow``'s
    count.  Returns what was held."""
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    t0 = time.perf_counter()
    nodes = int(0.95 * world * NUM_NODES)
    traffic = Traffic(seed + 31, nodes=nodes)
    one = sh.init_sharded(scfg)
    w = torch.ones(world * BATCH, dtype=torch.int32, device="cuda")
    predicted = np.zeros(world, dtype=np.int64)
    answers, tops = [], []
    for i in range(RANKS_WARM + RANKS_CALLS):
        src, dst = traffic.batch(world * BATCH)
        q = traffic.srcs(world * QUERIES)
        predicted += sh.predict_route_overflow(
            scfg, src.cpu().numpy()).reshape(world, -1).sum(axis=1)
        sh.update_(one, src, dst, w, scfg=scfg)
        a = sh.query(one, q, 0.9, 16, scfg=scfg)
        sh.maintain_(one, scfg=scfg, total_threshold=RANKS_THRESHOLD)
        t = sh.topn(one, TOP_N, scfg=scfg)
        if i >= RANKS_WARM:
            answers.append(a)
            tops.append(t)
    src, dst = skewed_batch(traffic, scfg, nodes)
    skewed = sh.predict_route_overflow(scfg, src.cpu().numpy()).reshape(
        world, -1).sum(axis=1)
    predicted += skewed
    sh.update_(one, src, dst, w, scfg=scfg)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    equal_states("[ranks] the gathered state vs the one-card stacked chain",
                 mc_to(gathered, one.slabs.cnt.device), one)
    if counters != mc.counter_stats(one):
        raise AssertionError(f"[ranks] counter_stats over the group {counters} "
                             f"!= the one-card chain's")
    rounds = len(answers)
    for x in range(4):     # dsts, probs, n_needed, dropped of every round
        want = torch.stack([a[x] for a in answers]).cpu()
        per = got[x].view(world, rounds, *got[x].shape[2:])
        mine = (torch.cat(list(per), dim=1) if x < 3
                else per.squeeze(-1).transpose(0, 1))
        if not torch.equal(mine, want):
            raise AssertionError(f"[ranks] query output {x} differs from the "
                                 f"one-card chain's")
    for x in range(4):     # srcs, dsts, probs, dropped of every top-16
        want = torch.stack([t[x] for t in tops]).cpu()
        per = got[4 + x].view(world, rounds, *want.shape[1:])
        for r in range(world):
            if not torch.equal(per[r], want):
                raise AssertionError(f"[ranks] rank {r}'s top-{TOP_N} output "
                                     f"{x} differs from the one-card chain's")
    drops = one.route_dropped.cpu().numpy()
    if not np.array_equal(drops, predicted) or skewed[0] <= 0:
        raise AssertionError(f"[ranks] route_dropped {drops.tolist()} != "
                             f"predicted {predicted.tolist()}")
    return {"replay_s": replay_s, "compare_s": time.perf_counter() - t0,
            "route_dropped": drops.tolist(),
            "predicted": predicted.tolist(), "rounds": rounds,
            "top_probs": tops[-1][2].tolist()[:4]}


ENGINE_LANE_READS = ENGINE_ROUNDS_RANKS = 20  # observes, and reads of each lane
ENGINE_SMALL_ROWS = 2 ** 16   # rows a shard of the ranked reassign and the
                              # elastic restore (a cut of depth: queue B W9)
ENGINE_SMALL_ROUNDS = 4       # observes before them, world x 16,384 each


def rank_engine(group, seed, root):
    """Phase ranks' serving engine, on every rank of ``group`` once its
    chain rounds have ended: ``ShardedEngine(cfg, ranks=group)`` at phase
    sharded's width (this rank's shard 2^20 x 128), two reader lanes; 20
    observes of world x 65,536 transitions (every rank the same global
    batches) while lane 0 queries 16,384 srcs and lane 1 reads the top-16,
    each read started after the writer's next observe on this rank, an
    async checkpoint after round 10; a crash (the engine closed) and a
    fresh engine's restore with WAL replay; then, at 2^16 rows a shard, 4
    observes, a reassign onto a map rotated by one shard, a checkpoint and
    the elastic restore onto half the ranks.  Every rank's answers equal
    rank 0's (digests); rank 0 holds them, the recovered state and the
    counters to an engine-free oracle and the small runs to the one-card
    engine (:func:`rank_engine_check`).  Returns this rank's figures, its
    launches over the 20 observes and their reads."""
    import datetime
    import hashlib
    import threading
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.serve.engine import ShardedEngine
    from repro_torch.sharding.ranks import RankGroup
    rank, world, device = group.rank, group.world, group.device
    scfg = ranks_config(world)
    cfg = dataclasses.replace(engine_config(os.path.join(root, "full"), scfg),
                              read_lanes=2)
    traffic = Traffic(seed + 37, nodes=int(0.95 * world * NUM_NODES))
    batches = [tuple(x.cpu().numpy() for x in traffic.batch(world * BATCH))
               for _ in range(ENGINE_ROUNDS_RANKS)]
    q = traffic.srcs(ENGINE_QUERIES).cpu().numpy()
    engine = ShardedEngine(cfg, ranks=group)
    # the lanes' collectives timed by events on the lane's stream, and the
    # version each read pinned
    comm = {0: [], 1: []}

    def clocked(lane, fn):
        def call(*args, **kw):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = fn(*args, **kw)
            pair[1].record()
            comm[lane].append(pair)
            return out
        return call

    for ln in engine._lanes:
        for name in ("all_to_all", "all_gather", "agree"):
            setattr(ln.group, name, clocked(ln.index, getattr(ln.group, name)))
    local = threading.local()
    acquire = engine.store.acquire

    def pinned():
        snap = acquire()
        local.version = snap.version
        return snap
    engine.store.acquire = pinned
    done, moved = [0], threading.Condition()
    reads, errors = {0: [], 1: []}, []

    def lane_loop(lane):
        try:
            for k in range(ENGINE_LANE_READS):
                with moved:
                    moved.wait_for(lambda: done[0] > k or done[0] < 0)
                if done[0] < 0:      # the writer failed: its error is raised
                    return
                comm[lane].clear()
                t0 = time.perf_counter()
                out = (engine.query(q, lane=0) if lane == 0
                       else engine.topn(TOP_N, lane=1))
                ms = (time.perf_counter() - t0) * 1e3
                share = sum(s.elapsed_time(e) for s, e in comm[lane]) / ms
                host = [x.cpu().numpy() for x in out]
                if lane == 1 and not (host[2][:-1] >= host[2][1:]).all():
                    raise AssertionError("a ranked top-16 is not sorted")
                reads[lane].append((local.version, ms, share, host))
        except BaseException as exc:       # re-raised on the main thread
            errors.append(exc)

    for mod in kernel_modules().values():
        mod.launches = 0
    threads = [threading.Thread(target=lane_loop, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    observe_ms = []
    try:
        for i, (src, dst) in enumerate(batches):
            t0 = time.perf_counter()
            engine.observe(src, dst)
            observe_ms.append((time.perf_counter() - t0) * 1e3)
            if i + 1 == ENGINE_CHECKPOINT_AFTER:
                engine.checkpoint(sync=False)
            with moved:
                done[0] = i + 1
                moved.notify_all()
    except BaseException:
        with moved:
            done[0] = -1
            moved.notify_all()
        raise
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    torch.cuda.synchronize(device)
    launches = {name: mod.launches for name, mod in kernel_modules().items()}
    stats = engine.stats_snapshot()
    digests = [[int.from_bytes(hashlib.blake2b(b"".join(
        np.ascontiguousarray(x).tobytes() for x in r[3]), digest_size=8)
        .digest(), "little", signed=True) for r in reads[lane]]
        for lane in (0, 1)]
    table = group.agree([r[0] for r in reads[0]] + [r[0] for r in reads[1]]
                        + digests[0] + digests[1])
    n = ENGINE_LANE_READS
    bad = [r for r in range(world)
           if (table[r, 2 * n:] != table[0, 2 * n:]).any()]
    if bad:
        raise AssertionError(f"[ranks] engine: ranks {bad}' answers differ "
                             f"from rank 0's")
    # a crash after round 20: a fresh engine restores and replays
    engine.close()
    del engine, acquire
    gc.collect()
    torch.cuda.empty_cache()
    engine = ShardedEngine(cfg, ranks=group)
    group.agree([0])
    t0 = time.perf_counter()
    info = engine.restore()
    torch.cuda.synchronize(device)
    restore_s = time.perf_counter() - t0
    want = {"step": ENGINE_CHECKPOINT_AFTER, "mode": "exact",
            "replayed": ENGINE_ROUNDS_RANKS - ENGINE_CHECKPOINT_AFTER,
            "wal_seq": ENGINE_ROUNDS_RANKS - 1}
    if info != want:
        raise AssertionError(f"[ranks] engine recovery: {info}, expected "
                             f"{want}")
    snap = engine.store.acquire()
    recovered = convert.gather_sharded(snap.state, group, 0)
    engine.store.release(snap)
    recovered_stats = engine.stats_snapshot()
    engine.close()
    del engine, snap
    gc.collect()
    torch.cuda.empty_cache()

    # the reassign and the elastic restore at 2^16 rows a shard
    small = dataclasses.replace(scfg, base=dataclasses.replace(
        scfg.base, num_rows=ENGINE_SMALL_ROWS))
    small_cfg = dataclasses.replace(
        engine_config(os.path.join(root, "small"), small), wal_dir=None)
    little = Traffic(seed + 41, nodes=int(0.95 * world * ENGINE_SMALL_ROWS))
    small_batches = [tuple(x.cpu().numpy() for x in little.batch(
        world * BATCH // 4)) for _ in range(ENGINE_SMALL_ROUNDS)]
    qs = little.srcs(ENGINE_QUERIES).cpu().numpy()
    own = small.resolved_ownership()
    rotated = type(own)(num_shards=world, num_buckets=own.num_buckets,
                        assignment=tuple((a + 1) % world
                                         for a in own.resolved_assignment()))
    eng = ShardedEngine(small_cfg, ranks=group)
    for src, dst in small_batches:
        eng.observe(src, dst)
    top_before = [x.cpu() for x in eng.topn(TOP_N)]
    group.agree([0])
    t0 = time.perf_counter()
    eng.reassign(rotated)
    torch.cuda.synchronize(device)
    reassign_s = time.perf_counter() - t0
    small_answers = [x.cpu() for x in (*eng.query(qs), *eng.topn(TOP_N))]
    snap = eng.store.acquire()
    reassigned = convert.gather_sharded(snap.state, group, 0)
    eng.store.release(snap)
    eng.checkpoint()
    eng.close()
    del eng, snap
    half, elastic = world // 2, None
    if half:
        sub = dist.new_group(ranks=list(range(half)), backend=group.backend,
                             timeout=datetime.timedelta(seconds=group.timeout))
        if rank < half:
            part = RankGroup(sub, rank, half, device, group.backend,
                             group.timeout)
            half_cfg = dataclasses.replace(small_cfg, sharded=dataclasses.replace(
                small, num_shards=half))
            eng = ShardedEngine(half_cfg, ranks=part)
            t0 = time.perf_counter()
            info2 = eng.restore()
            torch.cuda.synchronize(device)
            elastic_s = time.perf_counter() - t0
            if info2["mode"] != "reshard":
                raise AssertionError(f"[ranks] elastic restore: {info2}")
            got = [x.cpu() for x in (*eng.query(qs), *eng.topn(TOP_N))]
            snap = eng.store.acquire()
            state2 = convert.gather_sharded(snap.state, part, 0)
            eng.store.release(snap)
            eng.close()
            del eng, snap
            elastic = (elastic_s, got, state2)
    group.agree([0])
    out = {"engine_launches": launches, "observe_ms": observe_ms,
           "lane_ms": [[r[1] for r in reads[lane]] for lane in (0, 1)],
           "lane_share": [[r[2] for r in reads[lane]] for lane in (0, 1)],
           "versions": [[r[0] for r in reads[lane]] for lane in (0, 1)],
           "restore_s": restore_s, "replayed": info["replayed"],
           "reassign_s": reassign_s,
           "elastic_s": None if elastic is None else elastic[0]}
    if rank == 0:
        out["engine_checks"] = rank_engine_check(
            scfg, small, small_cfg, rotated, batches, small_batches, q, qs,
            table, reads, stats, recovered, recovered_stats, top_before,
            small_answers, reassigned, elastic, device)
    return out


def rank_engine_check(scfg, small, small_cfg, rotated, batches, small_batches,
                      q, qs, table, reads, stats, recovered, recovered_stats,
                      top_before, small_answers, reassigned, elastic, device):
    """Rank 0's side of :func:`rank_engine`: the engine-free oracle (the
    one-card stacked chain through ``sh.update_`` + ``sh.maintain_``) on
    the same batches; each lane read held to it at the versions its ranks
    pinned (a query's src answered by its owner's version, a top-16 merged
    from each shard's list at its rank's version, by the engine's own
    merge); the recovered state and the counters equal to it after the 20
    rounds; the reassign and the elastic restore equal to the one-card
    engine's on the same calls.  Returns what was held."""
    from repro_torch import core
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ShardedEngine
    t0 = time.perf_counter()
    world, n = scfg.num_shards, ENGINE_LANE_READS
    vq, vt = table[:, :n], table[:, n:2 * n]
    one = sh.init_sharded(scfg, device)
    w = torch.ones(world * BATCH, dtype=torch.int32, device=device)
    qd = torch.from_numpy(q).to(device)
    owner = scfg.resolved_ownership().owner_of(torch.from_numpy(q)).numpy()
    want_q = [[None] * 3 for _ in range(n)]
    lists = [[None] * world for _ in range(n)]

    def at_version(v):
        if (vq == v).any():
            got = [x.cpu().numpy() for x in sh.query(one, qd, 0.9, 16,
                                                     scfg=scfg)[:3]]
            for j, s in zip(*np.nonzero((vq == v).T)):
                rows = owner == s
                for x in range(3):
                    if want_q[j][x] is None:
                        want_q[j][x] = np.zeros_like(got[x])
                    want_q[j][x][rows] = got[x][rows]
        if (vt == v).any():
            for s in range(world):
                if not (vt[s] == v).any():
                    continue
                st = mc.map_leaves(lambda x: x[s:s + 1], one)  # a rank's
                srcs, dsts, probs, _ = ops.topn_windows(
                    st.slabs.cnt, st.slabs.order, st.slabs.tot, st.slabs.dst,
                    *st.src_table, n=TOP_N)
                for j in np.flatnonzero(vt[s] == v):
                    lists[j][s] = (probs.reshape(TOP_N), dsts.reshape(TOP_N),
                                   srcs.reshape(TOP_N))

    at_version(0)
    for v, (src, dst) in enumerate(batches, 1):
        sh.update_(one, torch.from_numpy(src).to(device),
                   torch.from_numpy(dst).to(device), w, scfg=scfg)
        sh.maintain_(one, scfg=scfg, total_threshold=ENGINE_THRESHOLD)
        at_version(v)
    for j, (_, _, _, got) in enumerate(reads[0]):
        for x in range(3):
            if not np.array_equal(got[x], want_q[j][x]):
                raise AssertionError(f"[ranks] engine lane 0 read {j} (versions "
                                     f"{vq[:, j].tolist()}): output {x} differs "
                                     f"from the oracle's")
    for j, (_, _, _, got) in enumerate(reads[1]):
        merged = ops.topn_merge(*(torch.stack([lists[j][s][x] for s in
                                               range(world)])
                                  for x in range(3)), n=TOP_N)
        for x in range(3):
            if not np.array_equal(got[x], merged[x].cpu().numpy()):
                raise AssertionError(f"[ranks] engine lane 1 read {j} (versions "
                                     f"{vt[:, j].tolist()}): output {x} differs "
                                     f"from the oracle's merge")
    equal_states("[ranks] the recovered ranked engine (gathered) vs the "
                 "uninterrupted oracle", mc_to(recovered, device), one)
    counters = core.counter_stats(one)
    for label, st in (("after the 20 rounds", stats),
                      ("after the restore", recovered_stats)):
        if {k: st[k] for k in counters} != counters:
            raise AssertionError(f"[ranks] engine counters {label} "
                                 f"{ {k: st[k] for k in counters} } != the "
                                 f"oracle's {counters}")
    mixed = int((vq != vq[0]).any(axis=0).sum() + (vt != vt[0]).any(axis=0).sum())
    top_probs = reads[1][-1][3][2][:4].tolist()
    del one, recovered
    torch.cuda.empty_cache()
    oracle_s = time.perf_counter() - t0

    # the small runs: the one-card engine over the same calls
    t0 = time.perf_counter()
    root = os.path.dirname(small_cfg.snapshot_dir)
    one_cfg = dataclasses.replace(small_cfg,
                                  snapshot_dir=os.path.join(root, "one_snap"))
    eng = ShardedEngine(one_cfg, device=device)
    for src, dst in small_batches:
        eng.observe(src, dst)
    one_top = [x.cpu() for x in eng.topn(TOP_N)]
    for x in range(3):
        if not torch.equal(top_before[x], one_top[x]):
            raise AssertionError("[ranks] small engine: top-16 before the "
                                 "reassign differs from the one-card engine's")
    eng.reassign(rotated)
    compare("[ranks] reassign: the ranked engine's query and top-16 vs the "
            "one-card engine's", small_answers,
            [x.cpu() for x in (*eng.query(qs), *eng.topn(TOP_N))])
    equal_states("[ranks] reassign: the ranked engine (gathered) vs the "
                 "one-card engine", mc_to(reassigned, device), published(eng))
    if not torch.equal(top_before[2], small_answers[5]):
        raise AssertionError("[ranks] reassign changed the top-16's "
                             "probabilities")
    eng.close()
    del eng
    checks = {"oracle_s": oracle_s, "mixed_reads": mixed,
              "top_probs": top_probs}
    if elastic is not None:
        half = elastic[2].slabs.cnt.shape[0]
        half_cfg = dataclasses.replace(small_cfg, sharded=dataclasses.replace(
            small, num_shards=half))
        eng = ShardedEngine(half_cfg, device=device)
        info = eng.restore()
        compare(f"[ranks] elastic {world} -> {half}: the ranked engine's query "
                f"and top-16 vs the one-card engine's", elastic[1],
                [x.cpu() for x in (*eng.query(qs), *eng.topn(TOP_N))])
        equal_states(f"[ranks] elastic {world} -> {half}: the ranked engine "
                     f"(gathered) vs the one-card engine",
                     mc_to(elastic[2], device), published(eng))
        eng.close()
        checks["elastic"] = f"{world} -> {half} ({info['mode']})"
    checks["small_s"] = time.perf_counter() - t0
    return checks


def mc_to(state, device):
    """A CPU state on ``device``, leaf by leaf (scalars kept as one
    tensor's columns)."""
    from repro_torch.core import mcprioq as mc
    return mc.private_copy(mc.map_leaves(lambda x: x.to(device), state),
                           table=False, slabs=(), dh=False)


class RankRun:
    """``world`` spawned processes ``target(rank, world, rdv, dir, go,
    *extra)`` (a ``file://`` rendezvous in a fresh directory; ``go`` an
    event the ranks wait on once set up, so that a group can start while
    another runs); :meth:`wait` fails, naming the rank, when a rank fails or
    the group outlives ``RANKS_LIMIT_S``; :meth:`close` kills what still
    runs."""

    def __init__(self, target, world, extra, label):
        import multiprocessing
        import tempfile
        ctx = multiprocessing.get_context("spawn")
        self.label, self.world = label, world
        self.work = tempfile.mkdtemp(prefix="mcq_ranks_")
        self.go = ctx.Event()
        self.started = time.time()
        self.procs = [ctx.Process(
            target=target, args=(r, world, f"file://{self.work}/rendezvous",
                                 self.work, self.go, *extra),
            name=f"{label} rank {r}") for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + RANKS_LIMIT_S

    def wait(self):
        """Each rank's JSON result, with ``ready_s``: spawn to ready."""
        while True:
            bad = [(r, p.exitcode) for r, p in enumerate(self.procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise AssertionError(f"[ranks] {self.label}: rank {bad[0][0]} "
                                     f"exited with {bad[0][1]}; its group "
                                     f"killed")
            if all(p.exitcode == 0 for p in self.procs):
                break
            if time.monotonic() > self.deadline:
                late = [r for r, p in enumerate(self.procs)
                        if p.exitcode is None]
                raise AssertionError(f"[ranks] {self.label}: ranks {late} ran "
                                     f"past {RANKS_LIMIT_S} s; the group "
                                     f"killed")
            time.sleep(0.05)
        results = [json.loads(Path(self.work, f"rank{r}.json").read_text())
                   for r in range(self.world)]
        for res in results:
            res["ready_s"] = res.pop("ready_at") - self.started
        return results

    def close(self):
        import shutil
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(self.work, ignore_errors=True)


def phase_ranks(seed, card):
    """The sharded chain one shard a process rank (``sharding.ranks``), on
    the card: (a) one NCCL rank beside the one-card chain at S = 1; (b) 4
    gloo ranks on the one card, host-staged; (c) NCCL across cards where
    the machine has two or more; each group then serves through the ranked
    engine (:func:`rank_engine`).  The kernels are built here first, so
    that no two ranks build at once; ranks are spawned (this process has a
    CUDA context).  Every group starts at once and sets itself up; each
    runs its rounds when the one before it has ended.  Returns the rank
    path's launches by kernel and run (the chain's, and the engine's as
    ``engine_<run>``)."""
    import shutil
    from repro_torch.kernels import _build
    _build.load()
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    groups = [("(b)", "gloo", SHARDS,
               "gloo, host-staged, 4 ranks on one card (not NCCL across "
               "cards)")]
    if cards >= 2:
        groups.append(("(c)", "nccl", min(SHARDS, cards),
                       f"NCCL across {min(SHARDS, cards)} cards"))
    # each engine's snapshot (once at full width, once at 2^16 rows) and
    # its 20 WAL records
    need = [(1.1 * world * 1.54 + 0.5) * 2 ** 30
            for world in [1] + [g[2] for g in groups]]
    roots = [persist_dir(x, f"ranks' engine {i}") for i, x in enumerate(need)]
    runs = []
    try:
        runs.append(RankRun(rank_nccl_one, 1, (seed, roots[0]),
                            "(a) NCCL world 1"))
        runs += [RankRun(rank_group_run, world, (backend, seed, root),
                         f"{tag} {what}")
                 for (tag, backend, world, what), root in zip(groups, roots[1:])]
        out = phase_ranks_report(runs, groups, card)
    finally:
        for run in runs:
            run.close()
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    if cards < 2:
        say("[ranks] one card: NCCL across cards not run")
    say(f"[ranks] phase wall {time.perf_counter() - t0:.1f} s (every group "
        f"spawned at its start)")
    return out


def phase_ranks_report(runs, groups, card):
    """Let each group of :func:`phase_ranks` run in turn, check its
    launches and print what it held and measured."""
    out = {}
    runs[0].go.set()
    t0 = time.perf_counter()
    (one,) = runs[0].wait()
    missing = [k for k in SHARDED_KERNELS if one["launches"].get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"[ranks] (a): the rank path never launched "
                             f"{missing}")
    out["nccl_world1"] = one["launches"]
    base = ranks_config(1).base
    say(f"[ranks] (a) NCCL, world 1, S = 1, {base.num_rows} rows x "
        f"{base.capacity} slots on cuda:0: {RANKS_CALLS} rounds of update_ "
        f"({BATCH} transitions) + query ({QUERIES} srcs) + maintain_ + "
        f"top-{TOP_N} after one unguarded; after every update_ and maintain_ "
        f"the 18 leaves torch.equal to the one-card chain at S = 1 on the "
        f"same batches, every query and top-{TOP_N} equal; the rank's calls "
        f"under set_sync_debug_mode('error'); rows {one['n_rows']}, "
        f"route_dropped {one['route_dropped']}; spawn to ready "
        f"{one['ready_s']:.1f} s, rounds with their checks "
        f"{one['rounds_s']:.1f} s, the group's turn {time.perf_counter() - t0:.1f}"
        f" s; the rank path's launches {one['launches']}")
    out["engine_nccl_world1"] = rank_engine_report("(a) NCCL world 1", 1,
                                                   [one], card)
    for run, (tag, backend, world, what) in zip(runs[1:], groups):
        run.go.set()
        t0 = time.perf_counter()
        results = run.wait()
        for r, res in enumerate(results):
            missing = [k for k in SHARDED_KERNELS
                       if res["launches"].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"[ranks] {tag} rank {r}: the rank path "
                                     f"never launched {missing}")
            say(f"[ranks] {tag} {what}, rank {r}: median ms (events, "
                f"{RANKS_CALLS} rounds after {RANKS_WARM}) "
                + ", ".join(f"{k} {v:.4f} (collectives "
                            f"{100 * res['comm_share'][k]:.1f} %)"
                            for k, v in res["median_ms"].items())
                + f"; spawn to ready {res['ready_s']:.1f} s, rounds "
                f"{res['rounds_s']:.1f} s, gathers {res['gather_s']:.1f} s; "
                f"launches {res['launches']}")
        checks = results[0]["checks"]
        say(f"[ranks] {tag} {what}: S = {world}, each rank "
            f"{NUM_NODES} x 128 ({world * BATCH} transitions a global update, "
            f"{BATCH} a rank, bucket factor 2.0; {world * QUERIES} srcs a "
            f"global query; top-{TOP_N}): the gathered state (18 stacked "
            f"leaves), the {checks['rounds']} timed rounds' queries and "
            f"top-{TOP_N}s of every rank and counter_stats over the group "
            f"torch.equal to the one-card stacked chain on the same batches "
            f"(replayed on rank 0 in {checks['replay_s']:.1f} s, compared in "
            f"{checks['compare_s']:.1f} s); route_dropped per rank "
            f"{checks['route_dropped']} == predict_route_overflow "
            f"{checks['predicted']} (a skewed round last); top-{TOP_N} probs "
            f"{checks['top_probs']}...; the group's turn "
            f"{time.perf_counter() - t0:.1f} s")
        out[f"{backend}_world{world}"] = [r["launches"] for r in results]
        out[f"engine_{backend}_world{world}"] = rank_engine_report(
            f"{tag} {what}", world, results, card)
    return out


def rank_engine_report(label, world, results, card):
    """Check and print what :func:`rank_engine` did on each rank of one
    group.  Returns each rank's launches over its 20 observes and reads
    (a dict for world 1, else a list by rank)."""
    for r, res in enumerate(results):
        missing = [k for k in ENGINE_KERNELS
                   if res["engine_launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"[ranks] {label} rank {r}: the ranked "
                                 f"engine never launched {missing}")
        lanes = "; ".join(
            f"{kind} lane p50 {pct(res['lane_ms'][i], 50):.2f} ms p99 "
            f"{pct(res['lane_ms'][i], 99):.2f} ms (collectives "
            f"{100 * statistics.median(res['lane_share'][i]):.1f} % by "
            f"events, median)"
            for i, kind in enumerate(("query", f"top-{TOP_N}")))
        elastic = ("" if res["elastic_s"] is None else
                   f", elastic restore onto {world // 2} ranks "
                   f"{res['elastic_s']:.2f} s")
        say(f"[ranks] {label} engine rank {r} ({card}): observe "
            f"({world * BATCH} transitions) p50 {pct(res['observe_ms'], 50):.2f}"
            f" ms p99 {pct(res['observe_ms'], 99):.2f} ms; {lanes}; restore "
            f"{res['restore_s']:.2f} s (read, scatter and replay of "
            f"{res['replayed']} records: "
            f"{res['replayed'] * world * BATCH / res['restore_s']:.0f} "
            f"transitions/s over the whole restore); reassign at "
            f"{ENGINE_SMALL_ROWS} rows a shard {res['reassign_s']:.2f} s"
            f"{elastic}; versions read by lane {res['versions']}; the "
            f"engine's turn {res['engine_s']:.1f} s; launches "
            f"{res['engine_launches']}")
    checks = results[0]["engine_checks"]
    say(f"[ranks] {label} engine: ShardedEngine(ranks=) at {world} x "
        f"{NUM_NODES} x 128, 2 reader lanes, {ENGINE_ROUNDS_RANKS} observes "
        f"with an async checkpoint after {ENGINE_CHECKPOINT_AFTER}, a crash "
        f"and a restore: every lane read ({ENGINE_LANE_READS} queries of "
        f"{ENGINE_QUERIES} srcs, {ENGINE_LANE_READS} top-{TOP_N}s, "
        f"{checks['mixed_reads']} of them pinned at versions that differ by "
        f"rank) equal on every rank and to the engine-free oracle at the "
        f"versions pinned, every top-{TOP_N} sorted; the recovered state (18 "
        f"leaves, gathered) and counter_stats equal to the uninterrupted "
        f"oracle's (checked in {checks['oracle_s']:.1f} s); at "
        f"{ENGINE_SMALL_ROWS} rows a shard, the reassign"
        + (f" and the elastic restore {checks['elastic']}"
           if "elastic" in checks else "")
        + f" equal to the one-card engine's (leaves, a query, the top-"
        f"{TOP_N}; {checks['small_s']:.1f} s); top-{TOP_N} probs "
        f"{checks['top_probs']}...")
    launches = [res["engine_launches"] for res in results]
    return launches[0] if world == 1 else launches


# ---------------------------------------------------------------------------
# phase 6b: the serving engine at full width
# ---------------------------------------------------------------------------

ENGINE_ROUNDS = 20          # observe calls served while two readers loop
ENGINE_CHECKPOINT_AFTER = 10  # checkpoint(sync=False) after this round
ENGINE_QUERIES = 16_384     # srcs per reader query
ENGINE_THRESHOLD = 64       # decay_threshold: maintain_ fires in the rounds
ENGINE_SLICE = 65_536       # reingest_slice_len of the reassign (default 256)
ENGINE_PLAIN_ROUNDS = 10    # observe calls timed with no reader running
TOPN_PACE_MS = 0.0          # least ms between two top-n reads (--topn-pace-ms)
ENGINE_KERNELS = SHARDED_KERNELS + ("copy_dirty_rows",)


def engine_config(root, scfg, **kw):
    from repro_torch.runtime.fault_tolerance import RetryPolicy
    from repro_torch.serve.engine import ShardedServeConfig
    return ShardedServeConfig(
        sharded=scfg, decay_threshold=ENGINE_THRESHOLD, topn=TOP_N,
        snapshot_dir=os.path.join(root, "snap"),
        wal_dir=os.path.join(root, "wal"), wal_fsync="rotate",
        reingest_slice_len=ENGINE_SLICE,
        retry=RetryPolicy(max_attempts=3, base_delay_s=1e-3, max_delay_s=1e-2),
        **kw)


def pct(values, q):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def start_engine_launcher():
    """Step 0 of phase engine, started early: ``python -m
    repro_torch.launch.serve`` as a user runs it, with a snapshot directory
    and a WAL of its own, then again with ``--restore``, then one shard a
    process rank (``--ranks gloo``: 4 ranks on this card), all in a thread
    beside phase kernels (correctness checks, nothing timed).  Returns the
    function that waits for them, checks them and returns the first run's
    printed rate (edges/s, measured beside phase kernels)."""
    import re
    import shutil
    import tempfile
    import threading
    repo = Path(__file__).resolve().parent
    root = tempfile.mkdtemp(prefix="mcq_launcher_")
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--num-shards",
           "4", "--requests", "20", "--snapshot-dir",
           os.path.join(root, "launcher_snap"), "--wal",
           os.path.join(root, "launcher_wal")]
    outs, errors, procs = {}, [], []
    # a failure before the check stops the runs too
    atexit.register(lambda: [p.kill() for p in procs])

    def runs():
        try:
            for run, args in (("first", cmd), ("restore", cmd + ["--restore"]),
                              ("ranks", cmd[:7] + ["--ranks", "gloo"])):
                t0 = time.perf_counter()
                proc = subprocess.Popen(args, env=env, cwd=repo,
                                        text=True, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE)
                procs.append(proc)
                stdout, stderr = proc.communicate(timeout=600)
                outs[run] = (proc.returncode, stdout, stderr,
                             time.perf_counter() - t0)
                if proc.returncode != 0:
                    return
        except BaseException as exc:   # raised again by the check
            errors.append(exc)

    thread = threading.Thread(target=runs, name="engine launcher",
                              daemon=True)
    thread.start()

    def finish():
        thread.join()
        shutil.rmtree(root, ignore_errors=True)
        if errors:
            raise errors[0]
        for run, (code, stdout, stderr, secs) in outs.items():
            for line in stdout.splitlines():
                say(f"[engine] launcher ({run}): {line}")
            say(f"[engine] launcher ({run}): exit {code} in {secs:.1f} s "
                f"(beside phase kernels)")
            if code != 0:
                raise AssertionError(f"the launcher ({run}) exited {code}: "
                                     f"{stderr[-3000:]}")
        restored = re.search(r"restored step (\d+) \(exact\), replayed (\d+) "
                             r"WAL batches through seq (\d+)",
                             outs["restore"][1])
        if not restored:
            raise AssertionError("the launcher's --restore run reported no "
                                 "restored snapshot step and replayed batches")
        if "20 requests, 40960 edges over 4 shards" not in outs["ranks"][1]:
            raise AssertionError("the launcher's --ranks gloo run printed no "
                                 "rate line from rank 0")
        return float(re.search(r"\((\d+) edges/s\)",
                               outs["first"][1]).group(1))
    return finish


def engine_meta(scfg):
    """The meta ``ShardedEngine.checkpoint`` writes, for a state that no
    engine wrote: WAL position -1, healthy, no retry queue."""
    from repro_torch.runtime.fault_tolerance import ShardHealth
    own = scfg.resolved_ownership()
    return {"wal_seq": -1, "num_shards": scfg.num_shards,
            "bucket_factor": scfg.bucket_factor,
            "ownership": {"num_buckets": own.num_buckets,
                          "assignment": list(own.resolved_assignment())},
            "base_cfg": dataclasses.asdict(scfg.base), "store_version": 0,
            "retry_queue": [], "health": ShardHealth(scfg.num_shards).dump()}


# the engine's counters of reads its fault ladder answered: a dispatch that
# raised is retried, then answered empty, and never raises to the reader
READ_FAULTS = ("degraded_answers", "dispatch_retries", "query_retried",
               "query_lost")


class Readers:
    """Reader threads looping on the engine's ``query`` and/or ``topn``
    until :meth:`join`: each call timed on the host clock (a read ends with
    the host reading its drop count, so the clock sees its latency), each
    top-n checked sorted descending and each query's probabilities checked
    (its rows' sorted share counted), the version each read pinned and the
    epochs published while it ran recorded; an exception in a thread is
    kept and re-raised by :meth:`join` on the caller's thread.  The engine
    turns a failing read into an empty answer, so :meth:`join` also fails
    on any read answered empty and on any ``READ_FAULTS`` counter that
    moved while the threads ran."""

    def __init__(self, engine, q, kinds=("query", "topn")):
        import threading
        self.engine, self.q = engine, q
        self.stop = threading.Event()
        self.errors, self.versions, self.lags = [], set(), []
        self.sorted_rows = self.rows = self.empty = 0
        stats = engine.stats_snapshot()
        self.faults = {k: stats[k] for k in READ_FAULTS}
        self.ms = {k: [] for k in kinds}
        self.local = threading.local()
        store = engine.store
        self._acquire = store.acquire

        def pinned():
            snap = self._acquire()
            self.local.version = snap.version
            return snap
        store.acquire = pinned
        self.threads = [threading.Thread(target=self._loop, args=(k,),
                                         name=f"reader-{k}") for k in kinds]
        for t in self.threads:
            t.start()

    def _loop(self, kind):
        try:
            while not self.stop.is_set():
                t0 = time.perf_counter()
                if kind == "query":
                    d, p, n = self.engine.query(self.q)
                else:
                    s, d, p = self.engine.topn(TOP_N)
                ms = (time.perf_counter() - t0) * 1e3
                self.ms[kind].append(ms)
                self.versions.add(self.local.version)
                self.lags.append(self.engine.store.version - self.local.version)
                if not bool((d >= 0).any()):
                    self.empty += 1
                if kind == "topn":
                    if not bool((p[:-1] >= p[1:]).all()):
                        raise AssertionError("a top-n answer is not sorted "
                                             "descending")
                    rest = TOPN_PACE_MS / 1e3 - (time.perf_counter() - t0)
                    if rest > 0:
                        self.stop.wait(rest)
                    continue
                # a query answers in each row's priority order, which the
                # odd-even passes keep approximately sorted (the paper's
                # contract): its share of sorted rows is counted, not held
                if d.shape != (self.q.size, 16) or not bool(
                        (torch.isfinite(p) & (p >= 0) & (p <= 1)).all()
                        & (p.sum(dim=1) <= 1 + 1e-5).all()):
                    raise AssertionError("a query answer is not [B, 16] "
                                         "probabilities in [0, 1]")
                self.sorted_rows += int((p[:, :-1] >= p[:, 1:]).all(dim=1).sum())
                self.rows += p.shape[0]
        except BaseException as exc:       # re-raised on the main thread
            self.errors.append(exc)

    def join(self):
        self.stop.set()
        for t in self.threads:
            t.join()
        del self.engine.store.acquire      # the store's own method again
        if self.errors:
            raise AssertionError(f"a reader thread raised: "
                                 f"{self.errors[0]!r}") from self.errors[0]
        stats = self.engine.stats_snapshot()
        moved = {k: stats[k] - v for k, v in self.faults.items()
                 if stats[k] != v}
        if moved or self.empty:
            raise AssertionError(f"the engine's fault ladder answered reads: "
                                 f"{self.empty} answered empty, counters "
                                 f"moved {moved}")


class ObserveClock:
    """``engine.observe`` timed per round on the host clock, beside the WAL
    append inside it (its ``wal.append`` wrapped) and whether the engine's
    async snapshot worker was writing while the round ran: what the tail of
    an observe is made of."""

    def __init__(self, engine):
        self.engine, self.rounds, self.wal_ms = engine, [], []
        append = engine.wal.append

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return append(*args, **kw)
            finally:
                self.wal_ms.append((time.perf_counter() - t0) * 1e3)
        engine.wal.append = timed

    def writing(self):
        return any(t.is_alive() for t in self.engine._io_threads)

    def observe(self, src, dst):
        busy = self.writing()
        t0 = time.perf_counter()
        self.engine.observe(src, dst)
        ms = (time.perf_counter() - t0) * 1e3
        self.rounds.append((ms, self.wal_ms[-1], busy or self.writing()))

    @property
    def ms(self):
        return [ms for ms, _, _ in self.rounds]

    def summary(self):
        quiet = [ms for ms, _, busy in self.rounds if not busy]
        tail = (f"p50 {pct(quiet, 50):.2f} ms p99 {pct(quiet, 99):.2f} ms"
                if quiet else "none")
        return ("per round, observe ms / its WAL append ms (S: the snapshot "
                "worker was writing): " + " ".join(
                    f"{ms:.1f}/{wal:.1f}{'S' if busy else ''}"
                    for ms, wal, busy in self.rounds)
                + f"; the {len(quiet)} rounds without the worker: {tail}")


@contextlib.contextmanager
def catch_up_events():
    """CUDA events around every ``ops.copy_bound_rows`` the learner launches
    (its catch-up), read after the block: yields the list of ms."""
    from repro_torch.kernels import ops
    real, events, out = ops.copy_bound_rows, [], []

    def timed_copy(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(*args, **kw)
        end.record()
        events.append((start, end))

    ops.copy_bound_rows = timed_copy
    try:
        yield out
    finally:
        ops.copy_bound_rows = real
        torch.cuda.synchronize()
        out.extend(s.elapsed_time(e) for s, e in events)


def commit_clock(io_thread, t0):
    """Start timing an async snapshot's commit: returns a function that
    waits for the worker and gives the milliseconds from ``t0`` to the
    moment the worker ended (not to the moment it is asked)."""
    import threading
    ended = []
    watcher = threading.Thread(
        target=lambda: (io_thread.join(), ended.append(time.perf_counter())))
    watcher.start()

    def ms():
        watcher.join()
        return (ended[0] - t0) * 1e3
    return ms


def prune_snapshots(directory, keep):
    """Remove every snapshot step directory but the newest ``keep``."""
    import shutil
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def engine_answers(engine, q):
    """One query and one top-n through the engine, as device tensors."""
    return (*engine.query(q), *engine.topn(TOP_N))


def oracle_answers(state, scfg, q):
    from repro_torch.core import sharded as sh
    return (*sh.query(state, q, 0.9, 16, scfg=scfg)[:3],
            *sh.topn(state, TOP_N, scfg=scfg)[:3])


def published(engine):
    snap = engine.store.acquire()
    engine.store.release(snap)
    return snap.state


def phase_engine(state, scfg, seed, launcher=None):
    """The serving engine (``repro_torch.serve.engine.ShardedEngine``) at
    phase sharded's full width, on ``state`` (phase sharded's final state,
    left as it is): the launcher as a user runs it; the state snapshotted
    and restored into the engine; 20 observes served while a query reader
    and a top-n reader loop; every leaf against an engine-free oracle; a
    crash and its recovery; the fault ladder; the stacked catch-up as a
    kernels entry; a live reassign with a reader running.  ``launcher``:
    step 0's check, its runs started earlier (``start_engine_launcher``)."""
    import gc
    import shutil
    from repro_torch import core, faults
    from repro_torch.core import epoch
    from repro_torch.core import sharded as sh
    from repro_torch.kernels import ops
    from repro_torch.persist import snapshot as snap_io
    from repro_torch.runtime.fault_tolerance import EngineWriteUnavailable
    from repro_torch.serve.engine import ShardedEngine
    from repro_torch.sharding import Ownership
    nbytes = state_bytes(state)
    record_bytes = 12 * SHARDS * BATCH
    root = persist_dir(2 * nbytes + 2 ** 30 + 64 * record_bytes, "engine")
    entries = []
    try:
        # step 0: the launcher, as a user runs it
        launcher_rate = (launcher or start_engine_launcher())()

        # step 1: phase sharded's state, snapshotted, restored into the engine
        cfg = engine_config(root, scfg)
        t0 = time.perf_counter()
        snap_io.save_snapshot(state, cfg.snapshot_dir, 0, engine_meta(scfg))
        save_s = time.perf_counter() - t0
        engine = ShardedEngine(cfg)
        t0 = time.perf_counter()
        info = engine.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if info != {"step": 0, "mode": "exact", "replayed": 0, "wal_seq": -1}:
            raise AssertionError(f"engine restore of phase sharded's state: {info}")
        equal_states("engine restore vs phase sharded's state",
                     published(engine), state)
        oracle = core.private_copy(published(engine))
        say(f"[engine] {cfg}")
        say(f"[engine] phase sharded's state ({nbytes / 2**30:.2f} GiB) "
            f"snapshotted in {save_s:.1f} s, restored into the engine (exact) "
            f"in {restore_s:.1f} s: every stacked leaf equal")

        traffic = Traffic(seed + 31, nodes=SHARD_NODES)
        batch = SHARDS * BATCH
        q = traffic.srcs(ENGINE_QUERIES).cpu().numpy()
        w = torch.ones(batch, dtype=torch.int32, device="cuda")

        def host_batch():
            src, dst = traffic.batch(batch)
            return src.cpu().numpy(), dst.cpu().numpy()

        def feed(src, dst):
            sh.update_(oracle, torch.from_numpy(src).cuda(),
                       torch.from_numpy(dst).cuda(), w, scfg=scfg)
            sh.maintain_(oracle, scfg=scfg, total_threshold=ENGINE_THRESHOLD)

        # step 2: serve while learning
        batches = [host_batch() for _ in range(ENGINE_ROUNDS)]
        decays = engine.stats["decay_steps"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clock, stall_ms = ObserveClock(engine), None
        with launch_window("engine", ENGINE_KERNELS) as launches, \
                catch_up_events() as catch_ms:
            readers = Readers(engine, q)
            try:
                for i, (src, dst) in enumerate(batches):
                    clock.observe(src, dst)
                    if i + 1 == ENGINE_CHECKPOINT_AFTER:
                        t0 = time.perf_counter()
                        engine.checkpoint(sync=False)
                        stall_ms = (time.perf_counter() - t0) * 1e3
                        # the worker's commit: capture to on_complete, its
                        # fsyncs included
                        commit = commit_clock(engine._io_threads[-1], t0)
                time.sleep(0.05)   # the readers meet the last version too
            finally:
                readers.join()
        commit_ms = commit()
        peak = torch.cuda.max_memory_allocated()
        if engine.stats["decay_steps"] <= decays:
            raise AssertionError("maintain_ never decayed in the rounds")
        versions = sorted(readers.versions)
        if len(versions) < 2:
            raise AssertionError(f"the readers saw one version only: {versions}")
        lags = np.bincount(readers.lags).tolist()
        say(f"[engine] {ENGINE_ROUNDS} observes of {batch} transitions with a "
            f"query reader ({ENGINE_QUERIES} srcs, t=0.9, k=16) and a top-"
            f"{TOP_N} reader looping: observe p50 {pct(clock.ms, 50):.2f} ms "
            f"p99 {pct(clock.ms, 99):.2f} ms = "
            f"{batch / pct(clock.ms, 50) * 1e3:.0f} transitions/s at p50 "
            f"({clock.summary()}); "
            f"catch-up (copy_dirty_rows, events) p50 {pct(catch_ms, 50):.4f} "
            f"ms; {len(readers.ms['query'])} queries p50 "
            f"{pct(readers.ms['query'], 50):.2f} ms p99 "
            f"{pct(readers.ms['query'], 99):.2f} ms = "
            f"{ENGINE_QUERIES / pct(readers.ms['query'], 50) * 1e3:.0f} srcs/s; "
            f"{len(readers.ms['topn'])} top-n (one started at most every "
            f"{TOPN_PACE_MS:g} ms) p50 "
            f"{pct(readers.ms['topn'], 50):.2f} ms p99 "
            f"{pct(readers.ms['topn'], 99):.2f} ms; versions read "
            f"{versions[0]}..{versions[-1]} ({len(versions)} distinct); "
            f"epochs published while a read ran (count by lag 0, 1, ...) "
            f"{lags}; checkpoint(sync=False) stalled the writer "
            f"{stall_ms:.1f} ms and its worker committed (fsynced) "
            f"{commit_ms:.1f} ms after the call; peak device memory "
            f"{peak / 2**30:.2f} GiB "
            f"(phase sharded's state, the oracle and the engine's two states "
            f"among it); every top-n sorted, query rows in sorted order "
            f"{readers.sorted_rows}/{readers.rows}; no reader raised, none "
            f"answered empty, {', '.join(READ_FAULTS)} unmoved")

        # step 3: the oracle, with no engine in between
        for src, dst in batches:
            feed(src, dst)
        equal_states("engine vs the engine-free oracle", published(engine),
                     oracle)
        st, want = engine.stats_snapshot(), core.counter_stats(oracle)
        if {k: st[k] for k in want} != want:
            raise AssertionError(f"engine counters {st} vs oracle {want}")
        compare("engine query and top-n vs the oracle's",
                engine_answers(engine, q), oracle_answers(oracle, scfg, q))
        say(f"[engine] oracle: the {ENGINE_ROUNDS} batches through sh.update_ "
            f"+ sh.maintain_ on a private copy of the restored state: every "
            f"stacked leaf, the device counters {want} and a query and top-"
            f"{TOP_N} equal to the engine's")

        # step 4: crash and recover
        engine.close()
        del engine, readers
        gc.collect()
        torch.cuda.empty_cache()
        prune_snapshots(cfg.snapshot_dir, keep=1)
        engine = ShardedEngine(cfg)
        t0 = time.perf_counter()
        info = engine.restore()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        want = {"step": ENGINE_CHECKPOINT_AFTER, "mode": "exact",
                "replayed": ENGINE_ROUNDS - ENGINE_CHECKPOINT_AFTER,
                "wal_seq": ENGINE_ROUNDS - 1}
        if info != want:
            raise AssertionError(f"recovery: {info}, expected {want}")
        equal_states("recovered engine vs the uninterrupted state",
                     published(engine), oracle)
        say(f"[engine] crash after round {ENGINE_ROUNDS}, a fresh engine: "
            f"restore + replay {info} in {recover_s:.1f} s; every stacked "
            f"leaf equal to the uninterrupted state")

        # observe with no reader running, its device busy share, the reads'
        # device time and idle-device latency
        plain = ObserveClock(engine)
        with catch_up_events() as plain_catch_ms:
            for _ in range(ENGINE_PLAIN_ROUNDS):
                src, dst = host_batch()
                plain.observe(src, dst)
                feed(src, dst)
        from torch.profiler import ProfilerActivity, profile
        profiled = [host_batch() for _ in range(3)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for src, dst in profiled:
                engine.observe(src, dst)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = report_profile("engine: 3 observes, no reader", prof, prof_ms)
        for src, dst in profiled:
            feed(src, dst)
        # a read ends in a host read of its drop count, so its device time
        # comes from the profiler, not from events behind a spin kernel
        reads = {}
        for key, fn in (("query", lambda: engine.query(q)),
                        ("topn", lambda: engine.topn(TOP_N))):
            fn()
            torch.cuda.synchronize()
            busy = None
            for attempt in range(3):   # a lost window is taken again
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                busy = report_profile(
                    f"engine: 5 {key} calls, no writer (window {attempt + 1})",
                    prof, wall_ms, lost_ok=True)
                if busy is not None:
                    break
            reads[key] = (None if busy is None else busy / 5, wall_ms / 5)
        say(f"[engine] {ENGINE_PLAIN_ROUNDS} observes with no reader, the "
            f"first {ENGINE_PLAIN_ROUNDS} of the recovered engine: p50 "
            f"{pct(plain.ms, 50):.2f} ms p99 {pct(plain.ms, 99):.2f} ms = "
            f"{batch / pct(plain.ms, 50) * 1e3:.0f} transitions/s at p50 "
            f"({plain.summary()}); "
            f"catch-up p50 {pct(plain_catch_ms, 50):.4f} ms; device busy "
            f"{100 * busy_ms / prof_ms:.1f} % of 3 profiled observes; "
            + "; ".join(f"{k}: device not measured (the profiler lost "
                        f"every record), {i:.3f} ms per call" if d is None
                        else f"{k}: device {d:.3f} ms of {i:.3f} ms per call "
                        f"(profiler on, 5 calls), busy {100 * d / i:.1f} %"
                        for k, (d, i) in reads.items()))

        # step 7 (before the fault ladder: the learner holds the flags of
        # its last write here): the stacked catch-up at full width
        lrn = engine._writer
        front, back = epoch._copied(lrn._front), epoch._copied(lrn._back)
        caught = [x.clone() for x in back]
        # the flags the last write left are all that differs: the back
        # caught up by them is the front, every tensor
        ops.copy_dirty_rows(front, caught, lrn._dirty.view(-1).clone(),
                            lrn._table_dirty.view(-1).clone(), impl="cuda")
        for i, (x, y) in enumerate(zip(caught, front)):
            if not torch.equal(x, y):
                raise AssertionError(f"stacked catch-up: tensor {i} is not "
                                     f"the front after it")
        del caught, front, back
        learner_catch_up_entry(entries, launches, "copy_dirty_rows[engine]",
                               lrn, extra=dict(shards=SHARDS))

        # step 5: the fault ladder on the card
        src, dst = host_batch()
        faults.arm("engine.publish", RuntimeError("transient publish fault"),
                   count=1)
        try:
            engine.observe(src, dst)
        finally:
            faults.reset()
        feed(src, dst)
        if engine.stats["apply_retries"] != 1:
            raise AssertionError(f"publish fault: apply_retries "
                                 f"{engine.stats['apply_retries']}")
        equal_states("after a retried publish fault vs the oracle",
                     published(engine), oracle)
        before = engine_answers(engine, q)
        src, dst = host_batch()
        faults.arm("engine.apply", RuntimeError("persistent apply fault"))
        try:
            engine.observe(src, dst)
            raise AssertionError("a persistent apply fault did not poison")
        except EngineWriteUnavailable:
            pass
        finally:
            faults.reset()
        if engine.write_available:
            raise AssertionError("the write path is not poisoned")
        compare("a poisoned engine serves the last epoch",
                engine_answers(engine, q), before)
        del before
        t0 = time.perf_counter()
        info = engine.restore()
        heal_s = time.perf_counter() - t0
        feed(src, dst)
        if not engine.write_available or info["replayed"] != 1:
            raise AssertionError(f"restore did not heal the poison: {info}")
        equal_states("healed engine vs the oracle", published(engine), oracle)
        say(f"[engine] fault ladder: a transient engine.publish fault retried "
            f"(apply_retries 1), the state equal to the oracle's; a persistent "
            f"engine.apply fault poisoned the write path while query and top-n "
            f"served the last epoch unchanged; restore() from the poison's "
            f"checkpoint-now + the ghost record {info} in {heal_s:.1f} s "
            f"healed it, equal to the oracle")
        del oracle
        gc.collect()
        torch.cuda.empty_cache()
        prune_snapshots(cfg.snapshot_dir, keep=1)

        # step 6: a live reassign, a reader querying
        own = scfg.resolved_ownership()
        new_own = Ownership(num_shards=SHARDS, num_buckets=own.num_buckets,
                            assignment=tuple((a + 1) % SHARDS for a in
                                             own.resolved_assignment()))
        old = published(engine)
        extracted = int(torch.count_nonzero(old.slabs.cnt))
        del old
        top_before = [x.cpu() for x in engine.topn(TOP_N)]
        torch.cuda.reset_peak_memory_stats()
        readers = Readers(engine, q, kinds=("query",))
        try:
            t0 = time.perf_counter()
            engine.reassign(new_own)
            torch.cuda.synchronize()
            reassign_s = time.perf_counter() - t0
        finally:
            readers.join()
        new = published(engine)
        stats = core.counter_stats(new)
        kept = int(torch.count_nonzero(new.slabs.cnt))
        if engine.cfg.sharded.ownership != new_own:
            raise AssertionError("reassign did not install the new map")
        if stats["route_dropped"] or stats["deferred_new"] or stats["evictions"]:
            raise AssertionError(f"reassign dropped or deferred: {stats}")
        if extracted != kept + stats["dropped_probes"]:
            raise AssertionError(f"reassign: {extracted} edges extracted, "
                                 f"{kept} kept + {stats['dropped_probes']} "
                                 f"dropped_probes")
        top_after = [x.cpu() for x in engine.topn(TOP_N)]
        if not torch.equal(top_after[2], top_before[2]):
            raise AssertionError("reassign changed the global top-16's "
                                 "probabilities")
        strict = top_before[2] > top_before[2][-1]
        pairs = [set(zip(t[0][strict].tolist(), t[1][strict].tolist()))
                 for t in (top_before, top_after)]
        if pairs[0] != pairs[1]:
            raise AssertionError("reassign changed the global top-16's edges")
        for s in range(SHARDS):
            inv = core.check_invariants(sh.shard_state(new, s), scfg.base)
            if not all(v for key, v in inv.items() if key != "sorted_fraction"):
                raise AssertionError(f"reassigned shard {s}: {inv}")
        del new
        say(f"[engine] reassign onto a map rotated by one shard, a query "
            f"reader running ({len(readers.ms['query'])} queries, versions "
            f"{sorted(readers.versions)}, none answered empty, "
            f"{', '.join(READ_FAULTS)} unmoved): {reassign_s:.1f} s, "
            f"{extracted / reassign_s:.0f} edges/s; {extracted} edges "
            f"extracted = {kept} kept + {stats['dropped_probes']} "
            f"dropped_probes; no routing drop, deferral or eviction; the "
            f"global top-{TOP_N} the same (probabilities, and the edges above "
            f"the 16th's tie); every shard's invariants hold; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        engine.close()
        del engine
        say(f"[engine] the launcher's own printed rate at its default sizes: "
            f"{launcher_rate:.0f} edges/s")
    finally:
        faults.reset()
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
    return entries


def engine_script(impl, root, batches, q):
    """Every surface of the engine at phase parity's size, S = 4 with a WAL
    and snapshots: observe, query, top-n; a transient publish fault and a
    poisoned write, each healed; a down shard, deferred writes and
    ``heal_shard``; an async checkpoint, a crash and a restore; ``reassign``
    4 -> 4 and an elastic restore 4 -> 2.  Returns every stacked leaf,
    answer and stats counter recorded, by name."""
    from repro_torch import convert, core, faults
    from repro_torch.core import sharded as sh
    from repro_torch.runtime.fault_tolerance import (EngineWriteUnavailable,
                                                     RetryPolicy)
    from repro_torch.serve.engine import ShardedEngine, ShardedServeConfig
    from repro_torch.sharding import Ownership
    base = core.MCConfig(num_rows=512, capacity=32, sort_passes=1,
                         max_new_per_batch=192, decay_block_rows=128,
                         impl=impl)

    def cfg_at(n):
        return ShardedServeConfig(
            sharded=sh.ShardedConfig(base=base, num_shards=n,
                                     bucket_factor=1.0),
            decay_threshold=64, topn=TOP_N,
            snapshot_dir=os.path.join(root, "snap"),
            wal_dir=os.path.join(root, "wal"), wal_fsync="never",
            retry=RetryPolicy(max_attempts=3, base_delay_s=1e-4,
                              max_delay_s=1e-3))

    rec = {}

    def snap(tag, eng):
        for k, v in convert.state_to_numpy(published(eng)).items():
            rec[f"{tag}/{k}"] = torch.from_numpy(v)
        for k, v in sorted(eng.stats_snapshot().items()):
            rec[f"{tag}/stats/{k}"] = torch.tensor(v)
        for i, x in enumerate(engine_answers(eng, q)):
            rec[f"{tag}/answer{i}"] = x.cpu()

    feed = iter(batches)
    eng = ShardedEngine(cfg_at(4))
    for _ in range(6):
        eng.observe(*next(feed))
    snap("observed", eng)
    faults.arm("engine.publish", RuntimeError("transient"), count=1)
    eng.observe(*next(feed))
    faults.reset()
    snap("transient", eng)
    eng.checkpoint()
    faults.arm("engine.apply", RuntimeError("persistent"))
    try:
        eng.observe(*next(feed))
        raise AssertionError("engine script: the write path did not poison")
    except EngineWriteUnavailable:
        pass
    finally:
        faults.reset()
    snap("poisoned", eng)
    eng.restore()
    snap("healed", eng)
    eng.mark_shard_down(1)
    eng.observe(*next(feed))
    snap("down", eng)
    if eng.heal_shard(1) != 1:
        raise AssertionError("engine script: heal_shard re-applied nothing")
    snap("heal", eng)
    eng.checkpoint(sync=False)
    eng.observe(*next(feed))
    eng.close()
    eng = ShardedEngine(cfg_at(4))
    info = eng.restore()
    rec["recovered/replayed"] = torch.tensor(info["replayed"])
    snap("recovered", eng)
    eng.reassign(Ownership(num_shards=4, assignment=tuple(
        (b + 1) % 4 for b in range(Ownership(num_shards=4).num_buckets))))
    snap("reassigned", eng)
    eng.observe(*next(feed))
    eng.checkpoint()
    eng.close()
    eng = ShardedEngine(cfg_at(2))
    info = eng.restore()
    if info["mode"] != "reshard":
        raise AssertionError(f"engine script: elastic restore {info}")
    snap("elastic", eng)
    eng.close()
    return rec


def parity_engine(seed, n_batches=12):
    """The engine script (:func:`engine_script`) once with the CUDA kernels
    and once with the plain versions: every stacked leaf, answer and stats
    counter equal."""
    import shutil
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 29)
    batches = []
    for _ in range(n_batches):
        src = randint(gen, -1, 900, (1024,))
        src = torch.where(randint(gen, 0, 2, (1024,)) == 1, src % 24, src)
        dst = (src * 7 + randint(gen, 0, 60, (1024,)) * 13) % 5000
        batches.append((src.cpu().numpy(), dst.cpu().numpy()))
    q = randint(gen, -1, 950, (400,)).cpu().numpy()
    root = persist_dir(2 ** 26, "parity engine")
    try:
        recs = {impl: engine_script(impl, os.path.join(root, impl), batches, q)
                for impl in ("cuda", "ref")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if list(recs["cuda"]) != list(recs["ref"]):
        raise AssertionError("engine script: the two runs recorded different "
                             "things")
    for name in recs["cuda"]:
        compare(f"parity engine {name}", recs["cuda"][name], recs["ref"][name])
    stats = {k.split("/")[-1]: int(v) for k, v in recs["cuda"].items()
             if k.startswith("elastic/stats/")}
    say(f"[parity] engine script at S=4 (512x32 per shard, WAL and "
        f"snapshots): {len(recs['cuda'])} recorded leaves, answers and "
        f"counters equal, CUDA kernels against plain versions; final "
        f"(elastic 4 -> 2) stats {stats}")
    for key, tag in (("apply_retries", "transient"), ("write_errors", "poisoned"),
                     ("deferred_writes", "down"), ("route_dropped", "observed"),
                     ("decay_steps", "observed")):
        if int(recs["cuda"][f"{tag}/stats/{key}"]) <= 0:
            raise AssertionError(f"engine script never exercised {key}")


# ---------------------------------------------------------------------------
# phase 7: durability — snapshot, WAL, crash recovery, the N -> M reshard
# ---------------------------------------------------------------------------

PERSIST_ROUNDS = 20       # WAL-logged rounds of the recovery
PERSIST_ASYNC_AFTER = 10  # the async snapshot is taken after this round
PERSIST_THRESHOLD = 64    # maybe_decay_'s threshold: it fires in every round
RESHARD_TO = 2            # the sharded state's 4 shards onto this many
RESHARD_SLICE = 65_536    # per-shard slice of a re-ingest batch
RESHARD_CHECK_SHARE = 8   # the kernel check between the ingest's halves
                          # takes the first 1/8 of each sender slice (its
                          # plain mirror walks items one by one: a cut of
                          # depth for the script's time, from 1/4)
INGEST_KERNELS = ("probe_find", "slab_update", "oddeven", "slow_path")


def state_bytes(state):
    from repro_torch.checkpoint import ckpt
    return sum(x.numel() * x.element_size()
               for x in ckpt._paths_and_leaves(state)[1])


def persist_dir(need, label):
    """A new temporary directory for ``need`` bytes of snapshots and logs,
    on whichever of the temporary directory and the checkout's ``build/``
    has more free space; raises, naming what it needs, when neither has
    enough."""
    import shutil
    import tempfile
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    free = {d: shutil.disk_usage(d).free for d in (tempfile.gettempdir(),
                                                   str(build))}
    where = max(free, key=free.get)
    if free[where] < need:
        raise AssertionError(
            f"{label} needs {need / 2**30:.2f} GiB free for its snapshots and "
            f"logs; the most free is {free[where] / 2**30:.2f} GiB in {where}")
    path = tempfile.mkdtemp(prefix="mcq_persist_", dir=where)
    say(f"[persist] {label}: {need / 2**30:.2f} GiB of snapshots and logs in "
        f"{path} ({free[where] / 2**30:.1f} GiB free)")
    return path


def gather_ms(state):
    """Milliseconds of the snapshot's device->host gather alone (the copy
    ``save_snapshot`` makes first)."""
    from repro_torch.checkpoint import ckpt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [ckpt._gather(x) for x in ckpt._paths_and_leaves(state)[1]]
    ms = (time.perf_counter() - t0) * 1e3
    del host
    return ms


def replay_into(state, cfg, wal_dir, after_seq):
    """WAL records after ``after_seq`` through the owner calls; returns
    ``(records, wall ms)``."""
    from repro_torch import core
    from repro_torch.persist.wal import WriteAheadLog
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _, src, dst, w in WriteAheadLog(wal_dir).replay(after_seq=after_seq):
        core.update_batch_(state, src, dst, w, cfg=cfg)
        core.maybe_decay_(state, cfg=cfg, total_threshold=PERSIST_THRESHOLD)
        n += 1
    torch.cuda.synchronize()
    return n, (time.perf_counter() - t0) * 1e3


def wal_append_ms(wal_dir, src, dst, appends=12):
    """Median ms per ``append`` of one batch under each fsync policy
    (segments of 4 records, so ``rotate`` rotates)."""
    from repro_torch.persist.wal import WriteAheadLog
    out = {}
    for policy in ("always", "rotate", "never"):
        times = []
        with WriteAheadLog(os.path.join(wal_dir, policy), segment_records=4,
                           fsync=policy) as wal:
            for _ in range(appends):
                t0 = time.perf_counter()
                wal.append(src, dst)
                times.append((time.perf_counter() - t0) * 1e3)
        out[policy] = statistics.median(times)
    return out


def phase_persist(seed, warm_batches):
    """Crash recovery of phase main's chain on the card, bit for bit: a
    sync snapshot after the warm-up, 20 WAL-logged rounds of
    ``update_batch_`` + ``maybe_decay_`` with an async snapshot after round
    10 (the rounds after it write while its worker runs), a "crash", a
    restore of the newest complete snapshot into a fresh chain on the card,
    the replay of the later records through the same owner calls, and every
    leaf and counter equal to the uninterrupted chain's; the same snapshot
    restored on the CPU equal to the card's restore; appends under each
    fsync policy."""
    import shutil
    from repro_torch import core
    from repro_torch.persist import snapshot as snap_io
    from repro_torch.persist.wal import WriteAheadLog
    cfg = main_config()
    traffic = Traffic(seed + 23)
    state = core.init(cfg)
    nbytes = state_bytes(state)
    record = 3 * 4 * BATCH
    root = persist_dir(2 * nbytes + (PERSIST_ROUNDS + 36) * record,
                       "chain recovery")
    snap_dir, wal_dir = os.path.join(root, "snap"), os.path.join(root, "wal")
    meta = {"num_shards": 1, "base_cfg": dataclasses.asdict(cfg)}
    try:
        t0 = time.perf_counter()
        for batch in range(warm_batches):
            core.update_batch_(state, *traffic.batch(BATCH), cfg=cfg)
            if batch % 10 == 9:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        say(f"[persist] chain {cfg.num_rows} x {cfg.capacity}, "
            f"{nbytes / 2**30:.2f} GiB in 18 leaves; warm-up {warm_batches} "
            f"batches of {BATCH} in {time.perf_counter() - t0:.1f} s; "
            f"counters {core.counter_stats(state)}")

        g_ms = gather_ms(state)
        t0 = time.perf_counter()
        snap_io.save_snapshot(state, snap_dir, 0, {**meta, "wal_seq": -1})
        save_ms = (time.perf_counter() - t0) * 1e3
        write_ms = max(save_ms - g_ms, 1e-3)
        say(f"[persist] save_snapshot (sync): {save_ms:.1f} ms; of it the "
            f"device->host gather alone {g_ms:.1f} ms = "
            f"{nbytes / g_ms / 1e6:.2f} GB/s, the npz write and commit "
            f"{write_ms:.1f} ms = {nbytes / write_ms / 1e6:.2f} GB/s")

        wal = WriteAheadLog(wal_dir, segment_records=8, fsync="rotate")
        commit = []
        for i in range(PERSIST_ROUNDS):
            src, dst = traffic.batch(BATCH)
            if i % 4 == 3:   # a quarter of the batch on new successors
                fresh = torch.rand(BATCH, generator=traffic.gen,
                                   device="cuda") < 0.25
                dst = torch.where(fresh, randint(traffic.gen, 0, 2**30,
                                                 (BATCH,)), dst)
            seq = wal.append(src.cpu().numpy(), dst.cpu().numpy())
            core.update_batch_(state, src, dst, cfg=cfg)
            core.maybe_decay_(state, cfg=cfg,
                              total_threshold=PERSIST_THRESHOLD)
            if i == PERSIST_ASYNC_AFTER - 1:
                at_snapshot = core.counter_stats(state)
                t0 = time.perf_counter()
                worker = snap_io.save_snapshot_async(
                    state, snap_dir, 1, {**meta, "wal_seq": seq},
                    on_complete=lambda t0=t0: commit.append(
                        (time.perf_counter() - t0) * 1e3))
                caller_ms = (time.perf_counter() - t0) * 1e3
                wal_seq = seq
        torch.cuda.synchronize()
        wal.close()
        rounds_done = time.perf_counter()
        worker.join()
        expect = core.counter_stats(state)
        moved = {k: expect[k] - at_snapshot[k]
                 for k in ("decay_steps", "deferred_new")}
        say(f"[persist] save_snapshot_async after round {PERSIST_ASYNC_AFTER}: "
            f"the caller waited {caller_ms:.1f} ms (sidecar + gather), the "
            f"manifest committed {commit[0]:.1f} ms after the call while "
            f"{PERSIST_ROUNDS - PERSIST_ASYNC_AFTER} more rounds wrote the "
            f"chain (they ended {(rounds_done - t0) * 1e3:.1f} ms after it); "
            f"moved in the replayed span: {moved}")
        if min(moved.values()) <= 0:
            raise AssertionError(f"the replayed span must decay and defer: {moved}")
        step = snap_io.latest_complete_step(snap_dir)
        if step != 1:
            raise AssertionError(f"newest complete snapshot is {step}, not 1")

        # the crash: recover from the files alone
        t0 = time.perf_counter()
        recovered, got_meta, _ = snap_io.restore_snapshot(core.init(cfg),
                                                          snap_dir)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        on_cpu, _, _ = snap_io.restore_snapshot(recovered, snap_dir,
                                                device="cpu")
        equal_states("restore on the CPU vs on the card", on_card(on_cpu),
                     recovered)
        del on_cpu
        core.scalars_of(recovered)
        with launch_window("persist/replay", ("probe_find", "slab_update",
                                              "oddeven", "slow_path",
                                              "decay_sort")):
            replayed, replay_ms = replay_into(recovered, cfg, wal_dir,
                                              got_meta["wal_seq"])
        if replayed != PERSIST_ROUNDS - PERSIST_ASYNC_AFTER or \
                got_meta["wal_seq"] != wal_seq:
            raise AssertionError(f"replayed {replayed} records after seq "
                                 f"{got_meta['wal_seq']}")
        equal_states("recovered vs uninterrupted chain", recovered, state)
        if core.counter_stats(recovered) != expect:
            raise AssertionError("recovered counter_stats differ")
        say(f"[persist] restore_snapshot (newest complete, step 1, into a "
            f"fresh chain on the card): {restore_ms:.1f} ms; the same "
            f"snapshot restored on the CPU equal to it; replay of {replayed} "
            f"records through update_batch_ + maybe_decay_: {replay_ms:.1f} "
            f"ms wall = {replayed * BATCH / replay_ms * 1e3:.0f} "
            f"transitions/s; all 18 leaves of the recovered chain equal to "
            f"the uninterrupted one's, counter_stats equal {expect}")

        # the replay's device busy share: the same replay under the profiler
        from torch.profiler import ProfilerActivity, profile
        del recovered
        again, _, _ = snap_io.restore_snapshot(core.init(cfg), snap_dir)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_ms = replay_into(again, cfg, wal_dir, wal_seq)
        busy_ms = report_profile(f"persist replay of {replayed} records", prof,
                                 prof_ms)
        equal_states("second recovery vs uninterrupted chain", again, state)
        say(f"[persist] replay's device busy share: {busy_ms:.1f} ms of "
            f"{prof_ms:.1f} ms wall with the profiler on = "
            f"{100 * busy_ms / prof_ms:.1f} %; of the unprofiled wall "
            f"{replay_ms:.1f} ms, {100 * busy_ms / replay_ms:.1f} %")
        del again

        appends = wal_append_ms(os.path.join(root, "fsync"),
                                *(x.cpu().numpy() for x in traffic.batch(BATCH)))
        say(f"[persist] WAL append of one {BATCH}-item batch "
            f"({record / 1024:.0f} KiB record), median of 12: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in appends.items()))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def warm_sharded(state, scfg, traffic, w, warm_batches):
    """Phase sharded's warm-up: ``warm_batches`` global batches through
    ``update_``."""
    from repro_torch.core import sharded as sh
    for i in range(warm_batches):
        sh.update_(state, *traffic.batch(scfg.num_shards * BATCH), w, scfg=scfg)
        if i % 10 == 9:
            torch.cuda.synchronize()
    torch.cuda.synchronize()


def sharded_warm(args):
    """Phase sharded's warm-up batches: 1/8 of ``--warm-batches`` (550), a
    cut of depth (fewer edges for the engine's reassign and the reshard to
    move) that keeps the whole script inside its time (half until the
    training phase came, 3/8 until the LM example came)."""
    return args.warm_batches // 8


def sharded_warm_state(seed, warm_batches):
    """Phase sharded's state after its warm-up, without its rounds (for
    ``--phases persist`` or ``engine`` without phase sharded)."""
    from repro_torch.core import sharded as sh
    scfg = sharded_config()
    state = sh.init_sharded(scfg)
    t0 = time.perf_counter()
    warm_sharded(state, scfg, Traffic(seed + 11, nodes=SHARD_NODES),
                 torch.ones(SHARDS * BATCH, dtype=torch.int32, device="cuda"),
                 warm_batches)
    say(f"[persist] phase sharded's warm-up alone: {warm_batches} global "
        f"batches in {time.perf_counter() - t0:.1f} s")
    return state, scfg


def row_totals(state):
    """``(src, tot)`` of every row holding a src, over every shard, on the
    device, sorted by src."""
    from repro_torch.core import sharded as sh
    s, n = state.slabs.tot.shape
    src = sh._src_of_row(state, n).reshape(-1)
    tot = state.slabs.tot.reshape(-1)
    keep = src >= 0
    src, order = torch.sort(src[keep])
    return src, tot[keep][order]


def edge_keys(src, dst, cnt):
    """The (src, dst) key of each host triple as int64 on the card, sorted,
    with its count."""
    src = torch.from_numpy(src).cuda().to(torch.int64)
    key = (src << 32) | (torch.from_numpy(dst).cuda().to(torch.int64) & 0xFFFFFFFF)
    key, order = torch.sort(key)
    return key, torch.from_numpy(cnt).cuda()[order], src[order]


def persist_reshard(box, scfg, profile=False):
    """The 4-shard state of phase sharded (``box``, a one-item list, so that
    the old state can be freed) snapshotted, restored, and resharded onto
    ``RESHARD_TO`` shards of twice the rows: ``extract_edges``,
    ``owner_of`` under the new default map, ``plan_batches`` with a
    per-shard slice of 65,536, the routed update with the new-edge bound
    lifted, ``settle_order_``.  Checks: no routing drop; every extracted
    edge is in the new state or counted in ``dropped_probes``; the new
    state's triples are the old ones less the dropped srcs' (whole srcs:
    a probe window only fills); each surviving src's ``tot`` unchanged; no
    inversion; every shard's invariants."""
    import shutil
    from repro_torch import core
    from repro_torch.core import sharded as sh
    from repro_torch.core import slab as sl
    from repro_torch.persist import reshard as rs
    from repro_torch.persist import snapshot as snap_io
    old = box.pop()
    nbytes = state_bytes(old)
    root = persist_dir(nbytes + 2**28, "reshard")
    try:
        own = scfg.resolved_ownership()
        meta = {"wal_seq": -1, "num_shards": scfg.num_shards,
                "base_cfg": dataclasses.asdict(scfg.base),
                "ownership": {"num_buckets": own.num_buckets,
                              "assignment": list(own.resolved_assignment())}}
        g_ms = gather_ms(old)
        t0 = time.perf_counter()
        snap_io.save_snapshot(old, root, 0, meta)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        restored, got_meta, _ = snap_io.restore_snapshot(sh.init_sharded(scfg),
                                                         root)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        equal_states("sharded snapshot restored vs saved", restored, old)
        if got_meta != meta:
            raise AssertionError("sharded snapshot's sidecar differs")
        say(f"[persist] sharded state {nbytes / 2**30:.2f} GiB: save_snapshot "
            f"{save_ms:.1f} ms (gather alone {g_ms:.1f} ms = "
            f"{nbytes / g_ms / 1e6:.2f} GB/s; npz write "
            f"{nbytes / max(save_ms - g_ms, 1e-3) / 1e6:.2f} GB/s); restore_snapshot "
            f"into a fresh stacked state on the card {restore_ms:.1f} ms; "
            f"every stacked leaf equal")
        old_src, old_tot = row_totals(old)
        del old
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        src, dst, cnt = rs.extract_edges(restored)
        extract_ms = (time.perf_counter() - t0) * 1e3
        del restored
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = dataclasses.replace(scfg.base,
                                   num_rows=scfg.base.num_rows * scfg.num_shards
                                   // RESHARD_TO)
        new_scfg = sh.ShardedConfig(base=base, num_shards=RESHARD_TO,
                                    bucket_factor=2.0)
        t0 = time.perf_counter()
        owner = new_scfg.resolved_ownership().owner_of(
            torch.from_numpy(src).cuda()).cpu().numpy()
        owner_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cap = new_scfg.bucket_capacity(RESHARD_SLICE)
        batches = list(rs.plan_batches(src, dst, cnt, owner, RESHARD_TO,
                                       RESHARD_SLICE, cap))
        plan_ms = (time.perf_counter() - t0) * 1e3
        say(f"[persist] extract_edges: {src.size} live edges in "
            f"{extract_ms:.1f} ms; owner_of under the default map of "
            f"{RESHARD_TO} shards {owner_ms:.1f} ms (edges per new shard "
            f"{np.bincount(owner, minlength=RESHARD_TO).tolist()}); "
            f"plan_batches {plan_ms:.1f} ms: {len(batches)} routed updates of "
            f"{RESHARD_TO} x {RESHARD_SLICE} (bucket capacity {cap})")

        ingest_scfg = dataclasses.replace(new_scfg, base=dataclasses.replace(
            base, max_new_per_batch=0))
        new = sh.init_sharded(new_scfg)

        def ingest(batch):
            sh.update_(new, *(torch.from_numpy(x).cuda() for x in batch),
                       scfg=ingest_scfg)

        def ingest_span(label, span, skip=0):
            """``span``'s routed updates in a launch window of their own,
            timed after the first ``skip`` (profiled) ones."""
            pending = iter(span)
            with launch_window(label, INGEST_KERNELS) as got:
                if skip:
                    profile_window("persist ingest (routed update, new-edge "
                                   "bound lifted)", lambda: ingest(next(pending)),
                                   rounds=skip)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i, batch in enumerate(pending):
                    ingest(batch)
                    if i % 10 == 9:
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
                span_ms = (time.perf_counter() - t0) * 1e3
            return got, span_ms

        # the ingest in two halves, so that the new-edge pass is held against
        # its plain version on the routed inputs of the update between them
        # (outside both launch windows)
        half = len(batches) // 2
        skip = min(3, half) if profile else 0
        timed_edges = sum(int((b[0] >= 0).sum()) for b in batches[skip:])
        first, first_ms = ingest_span("persist/ingest, first half",
                                      batches[:half], skip)
        peak = torch.cuda.max_memory_allocated()
        entry = reshard_slow_path_entry(new, ingest_scfg, batches[half],
                                        RESHARD_CHECK_SHARE)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        second, second_ms = ingest_span("persist/ingest, second half",
                                        batches[half:])
        launches = {k: first[k] + second[k] for k in first}
        entry["launches"] = launches["slow_path"]
        say(f"[persist/ingest] kernel launches over both halves: {launches}")
        ingest_ms = first_ms + second_ms
        del batches
        t0 = time.perf_counter()
        rs.settle_order_(new)
        torch.cuda.synchronize()
        settle_ms = (time.perf_counter() - t0) * 1e3
        peak = max(peak, torch.cuda.max_memory_allocated())
        stats = core.counter_stats(new)
        say(f"[persist] ingest into {ingest_scfg}: {ingest_ms:.1f} ms = "
            f"{timed_edges / ingest_ms * 1e3:.0f} re-ingested edges/s"
            f"{f' (the {skip} profiled updates left out)' if skip else ''}; "
            f"settle_order_ {settle_ms:.1f} ms; rows per new shard "
            f"{new.n_rows.tolist()}; counters {stats}; peak device memory "
            f"of the ingest and the settle since the old state was freed "
            f"{peak / 2**30:.2f} GiB (the kernel check between the halves "
            f"left out)")

        if stats["route_dropped"] or stats["deferred_new"] or stats["dropped_rows"]:
            raise AssertionError(f"the reshard dropped routes, deferred or "
                                 f"dropped rows: {stats}")
        n_src, n_dst, n_cnt = rs.extract_edges(new)
        dropped = stats["dropped_probes"]
        if src.size != n_src.size + dropped:
            raise AssertionError(f"{src.size} edges extracted, {n_src.size} in "
                                 f"the new state + {dropped} dropped_probes")
        key_o, cnt_o, src_o = edge_keys(src, dst, cnt)
        key_n, cnt_n, _ = edge_keys(n_src, n_dst, n_cnt)
        del src, dst, cnt, owner
        new_src, new_tot = row_totals(new)
        kept = torch.isin(src_o, new_src)
        if not (torch.equal(key_o[kept], key_n) and torch.equal(cnt_o[kept], cnt_n)
                and int((~kept).sum()) == dropped):
            raise AssertionError("the new state's (src, dst, cnt) triples are "
                                 "not the old ones less the dropped srcs'")
        at = torch.searchsorted(old_src, new_src).clamp(max=old_src.numel() - 1)
        if not (torch.equal(old_src[at], new_src) and torch.equal(old_tot[at], new_tot)):
            raise AssertionError("a surviving src's tot changed")
        inv_rows = 0
        for r in range(RESHARD_TO):
            one = sh.shard_state(new, r)
            inv_rows += int((sl.inversions(one.slabs.cnt, one.slabs.order) > 0).sum())
            inv = core.check_invariants(one, base)
            if not all(v for k, v in inv.items() if k != "sorted_fraction"):
                raise AssertionError(f"new shard {r}: invariants violated: {inv}")
        if inv_rows:
            raise AssertionError(f"{inv_rows} rows keep an inversion after the settle")
        say(f"[persist] reshard 4 -> {RESHARD_TO}: no routing drop; "
            f"{n_src.size} edges in the new state + {dropped} dropped_probes "
            f"(queue C 11: {int((~kept).sum())} edges of "
            f"{int(old_src.numel() - new_src.numel())} srcs) = the extracted "
            f"edges; the triples equal the old ones less the dropped srcs'; "
            f"{new_src.numel()} surviving srcs' tot unchanged; no inversion; "
            f"every shard's invariants hold")
        del new
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return [entry]


def reshard_slow_path_entry(new, scfg, batch, share=1):
    """The new-edge pass at the reshard's shapes: shard 0's items of one
    routed ingest update (``batch``, the new-edge bound lifted; only the
    first ``1/share`` of each sender's slice active) as ``update_batch_``
    hands them to ``ops.slow_path_`` on the half-filled new state, held
    equal to its plain version and timed (``slow_path_entry``, on copies).
    Every item of a re-ingest is a new edge, so the fast path leaves the
    state as it is and these are the pass's exact inputs.  The entry's
    ``launches`` are the ingest's, filled in by the caller."""
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import sharded as sh
    from repro_torch.core.hashtable import EMPTY
    cfg = scfg.base
    one = sh.shard_state(new, 0)
    g_src, g_dst, g_w = (torch.from_numpy(x).cuda() for x in batch)
    per = g_src.numel() // scfg.num_shards
    g_src = torch.where(torch.arange(g_src.numel(), device="cuda") % per
                        < per // share, g_src, EMPTY)
    (rsrc, rdst, rw), *_ = sh._route(scfg, new, g_src, (g_dst, g_w))
    src, dst, w, m = mc._batch_inputs(one, rsrc[0], rdst[0], rw[0],
                                      rsrc[0] != EMPTY)
    u_src, u_dst, u_w, u_act, u_pos = mc._aggregate_batch(src, dst, w, m)
    rows0, found_src0 = mc.lookup_rows(one, u_src, cfg)
    _, found_d0 = mc._find_slots(one, rows0, u_dst, cfg)
    fast = u_act & found_src0 & found_d0
    p_src, p_dst, p_w, p_mask, overflow = mc._take_new_prefix(
        u_src, u_dst, u_w, u_pos, u_act & ~fast, cfg.resolved_max_new(len(src)))
    if int(fast.sum()) or int(overflow):
        raise AssertionError(f"a re-ingest update found {int(fast.sum())} "
                             f"known edges and deferred {int(overflow)}")
    counters = torch.stack([one.n_rows, one.dropped_rows, one.dropped_probes,
                            one.evictions])
    entries = []
    slow_path_entry(entries, {"slow_path": None},
                    torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda"),
                    "slow_path[reshard]", cfg, one.src_table, one.slabs,
                    counters, (p_src, p_dst, p_w, p_mask), sequential=False)
    entries[0].update(bucket_slots=len(src), items_of_new_srcs=int(
        (u_act & ~found_src0).sum()), active_share_of_the_update=1 / share)
    return entries[0]


def parity_reshard(seed, batches=16):
    """A small reshard, 4 -> 2 and 4 -> 8 at phase parity's sizes, once with
    the CUDA kernels and once with the plain versions: the old states, and
    every stacked leaf after the unbounded ingest and after the settle,
    equal."""
    from repro_torch import core
    from repro_torch.core import sharded as sh
    from repro_torch.persist import reshard as rs
    base = core.MCConfig(num_rows=512, capacity=32, sort_passes=1,
                         max_new_per_batch=192, decay_block_rows=128)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 29)
    olds = {}
    for impl in ("cuda", "ref"):
        scfg = sh.ShardedConfig(base=dataclasses.replace(base, impl=impl),
                                num_shards=4, bucket_factor=2.0)
        olds[impl] = sh.init_sharded(scfg)
    for i in range(batches):
        src = randint(gen, -1, 900, (1024,))
        src = torch.where(randint(gen, 0, 2, (1024,)) == 1, src % 24, src)
        dst = (src * 7 + randint(gen, 0, 60, (1024,)) * 13) % 5000
        w = randint(gen, 1, 4, (1024,))
        for impl, st in olds.items():
            scfg = sh.ShardedConfig(base=dataclasses.replace(base, impl=impl),
                                    num_shards=4, bucket_factor=2.0)
            sh.update_(st, src, dst, w, scfg=scfg)
            sh.maintain_(st, scfg=scfg, total_threshold=300)
    equal_states("parity reshard: the 4-shard states", olds["cuda"], olds["ref"])
    src, dst, cnt = rs.extract_edges(olds["cuda"])
    for m in (2, 8):
        new = {}
        for impl in ("cuda", "ref"):
            scfg = sh.ShardedConfig(base=dataclasses.replace(base, impl=impl),
                                    num_shards=m, bucket_factor=2.0)
            ingest = dataclasses.replace(scfg, base=dataclasses.replace(
                scfg.base, max_new_per_batch=0))
            owner = scfg.resolved_ownership().owner_of(
                torch.from_numpy(src)).numpy()
            st = sh.init_sharded(scfg)
            for b in rs.plan_batches(src, dst, cnt, owner, m, 256,
                                     scfg.bucket_capacity(256)):
                sh.update_(st, *(torch.from_numpy(x).cuda() for x in b),
                           scfg=ingest)
            new[impl] = st
        equal_states(f"parity reshard 4 -> {m}: ingested", new["cuda"], new["ref"])
        for st in new.values():
            rs.settle_order_(st)
        equal_states(f"parity reshard 4 -> {m}: settled", new["cuda"], new["ref"])
        stats = core.counter_stats(new["cuda"])
        if stats["route_dropped"] or stats["deferred_new"]:
            raise AssertionError(f"parity reshard 4 -> {m} dropped: {stats}")
        say(f"[parity] reshard 4 -> {m} at {base.num_rows}x{base.capacity} per "
            f"shard: {src.size} edges re-ingested with the new-edge bound "
            f"lifted (slices of 256), every stacked leaf equal to the plain "
            f"versions' after the ingest and after settle_order_; counters "
            f"{stats}")


# ---------------------------------------------------------------------------
# phase 8: the expert monitor at deepseek-moe-16b's routing widths
# ---------------------------------------------------------------------------

# src/repro/configs/deepseek_moe_16b.py:12,21-22: 28 layers, 64 routed
# experts, 6 experts per token
MOE_LAYERS, MOE_EXPERTS, MOE_TOP_K = 28, 64, 6
MOE_TOKENS = 4_096


def on_card(state):
    """A chain's leaves copied to the card (for comparing with one there)."""
    from repro_torch.core import mcprioq as mc
    return mc.map_leaves(lambda x: x.cuda(), state)


def phase_monitor(seed, steps=20):
    """The monitor observes ``steps`` router histograms per layer (4,096
    tokens x 6 experts, some layers collapsed onto a few experts) on the
    card, and the same on the CPU, where every call runs the plain
    versions: every leaf, ``balance_report`` and ``hot_experts`` equal."""
    from repro_torch.core import expert_monitor as em
    cfg = em.MonitorConfig(num_layers=MOE_LAYERS, num_experts=MOE_EXPERTS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 13)
    card, plain = em.init(cfg), em.init(cfg, device="cpu")
    say(f"[monitor] {cfg}: {cfg.mc_config()}")
    observe_ms = []
    for step in range(steps):
        for layer in range(MOE_LAYERS):
            # layers 0, 7, 14, 21 collapse: a few hot experts take most tokens
            weights = torch.ones(MOE_EXPERTS, device="cuda")
            if layer % 7 == 0:     # drifting: the hot set moves every 5 steps
                hot = (layer + step // 5 + torch.arange(MOE_TOP_K)) % MOE_EXPERTS
                weights[hot] = 500.0
            choice = torch.multinomial(weights.expand(MOE_TOKENS, -1), MOE_TOP_K,
                                       generator=gen)
            counts = torch.bincount(choice.view(-1), minlength=MOE_EXPERTS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = em.observe(card, layer, counts, cfg)
            torch.cuda.synchronize()
            observe_ms.append((time.perf_counter() - t0) * 1e3)
            plain = em.observe(plain, layer, counts.cpu(), cfg)
        equal_states(f"monitor step {step}", card, on_card(plain))
    t0 = time.perf_counter()
    report = em.balance_report(card, cfg, t=0.9)
    report_ms = (time.perf_counter() - t0) * 1e3
    if report != em.balance_report(plain, cfg, t=0.9):
        raise AssertionError("balance_report differs from the plain versions'")
    for layer in range(MOE_LAYERS):
        got = em.hot_experts(card, layer, 0.5, cfg)
        want = em.hot_experts(plain, layer, 0.5, cfg)
        compare(f"hot_experts layer {layer}", got[:2], [x.cuda() for x in want[:2]])
        if got[2] != want[2]:
            raise AssertionError(f"hot_experts layer {layer}: n_needed differs")
    collapsed = [report[layer] for layer in range(0, MOE_LAYERS, 7)]
    balanced = [report[layer] for layer in range(MOE_LAYERS) if layer % 7]
    say(f"[monitor] {steps} steps x {MOE_LAYERS} layers observed; every leaf "
        f"after every step, balance_report and hot_experts equal to the plain "
        f"versions' on the CPU; n_needed at t=0.9: collapsed layers {collapsed}, "
        f"balanced layers {min(balanced)}-{max(balanced)} of {MOE_EXPERTS}; "
        f"decay steps {int(card.decay_steps)}")
    say(f"[monitor] observe: median {statistics.median(observe_ms):.3f} ms per "
        f"call (host clock, synchronised); balance_report over {MOE_LAYERS} "
        f"layers {report_ms:.3f} ms")
    if max(collapsed) >= min(balanced):
        raise AssertionError(f"the monitor does not flag the collapsed layers: {report}")


def small_topn_checks(gen, both):
    """The merge against its plain version at odd small shapes: S 1..32
    lists of M 1..300, n from 1 to min(S·M + 3, 400), and 33 to 1,100 lists (one
    launch up to 1,024 lists at n <= 256, more above); descending lists
    with ties within and across lists and dead tails, lists that are not
    descending, all-zero lists, and lists with NaN, -0.0 and negative
    heads."""
    from repro_torch.kernels import ops

    def lists(s, m, kind):
        probs = randint(gen, 0, 6, (s, m)).float() / 8
        if kind == "descending":
            probs = torch.sort(probs, dim=1, descending=True).values
            probs[:, m // 2 + 1:] = 0.0
        elif kind == "zeros":
            probs.zero_()
        elif kind == "nan":
            r = torch.rand((3, s, m), generator=gen, device="cuda")
            probs[r[0] < 0.2] = float("nan")
            probs[r[1] < 0.2] = -0.0
            probs[r[2] < 0.1] = -0.5
        live = probs > 0
        dsts = torch.where(live, randint(gen, 0, 500, (s, m)), -1).to(torch.int32)
        srcs = torch.where(live, randint(gen, 0, 500, (s, m)), -1).to(torch.int32)
        return probs, dsts, srcs

    cases = 0
    for s in (1, 2, 3, 5, 8, 13, 17, 31, 32):
        for m in (1, 2, 7, 64, 300):
            for kind in ("descending", "unsorted", "zeros", "nan"):
                # past S·M every list is exhausted; above 256 steps the
                # kernel writes its steps out in more than one round.  The
                # plain version takes a step at a time, so n stops at 400
                # (S·M + 3 up to S·M = 397: S 1 at M 300, S 1-5 at M 64)
                for n in sorted({1, min(m, 17), 40, min(s * m + 3, 400)}):
                    both(f"topn_merge S={s} M={m} n={n} {kind}", ops.topn_merge,
                         *lists(s, m, kind), n=n)
                    cases += 1
    for s in (33, 100, 1024, 1100):
        for m in (1, 7):
            for kind in ("descending", "nan"):
                for n in (1, 16, 300):
                    both(f"topn_merge S={s} M={m} n={n} {kind}", ops.topn_merge,
                         *lists(s, m, kind), n=n)
                    cases += 1
    say(f"[kernels] topn_merge: {cases} small cases, S 1-32 (M 1-300, n 1 to "
        f"min(S*M+3, 400)) and 33-1,100 (n 1-300); equal to the plain "
        f"version")


def topn_state(gen, s, rows, c, kind, offset=False):
    """Stacked slabs and src tables for the window kernel, ``(cnt, order,
    tot, dst, tab_keys, tab_vals)``: counts 1-3 (``ties``: all 2; ``sparse``: 2 % live;
    ``empty``: none) so probabilities tie often, an order sorted by count
    with ties at random (``shuffled``: a random permutation), totals at or
    above a row's sum; src tables whose free lanes hold, one in ten, a key
    whose row is past the rows (N to N + 2: no row's src); ``offset`` puts
    cnt and order 4 B off a 16-B boundary (the kernel's 4-B copies)."""
    density = {"sparse": 0.02, "empty": 0.0}.get(kind, 0.6)
    live = torch.rand((s, rows, c), generator=gen, device="cuda") < density
    cnt = torch.where(live, randint(gen, 1, 4, (s, rows, c)), 0)
    if kind == "ties":
        cnt = torch.full_like(cnt, 2)
    noise = torch.rand((s, rows, c), generator=gen, device="cuda")
    key = noise if kind == "shuffled" else -cnt.float() - 0.5 * noise
    order = torch.argsort(key, dim=2).to(torch.int32)
    tot = cnt.sum(dim=2).to(torch.int32)
    if kind not in ("ties", "empty"):
        tot += randint(gen, 0, 3, (s, rows))
    dst = randint(gen, 0, 5000, (s, rows, c))
    # src tables of 2 N lanes: about 70 % of the rows held, at random lanes,
    # some lanes TOMB, some free lanes past the rows
    table = 2 * rows
    lanes = torch.argsort(torch.rand((s, table), generator=gen,
                                     device="cuda"), dim=1)
    lane, free = lanes[:, :rows], lanes[:, rows:]
    held = torch.rand((s, rows), generator=gen, device="cuda") < 0.7
    keys = torch.full((s, table), -1, dtype=torch.int32, device="cuda")
    vals = torch.full((s, table), -1, dtype=torch.int32, device="cuda")
    node = torch.arange(s * rows, dtype=torch.int32, device="cuda").view(s, rows)
    keys.scatter_(1, lane, torch.where(held, node * 7 + 3, -2).to(torch.int32))
    vals.scatter_(1, lane, torch.arange(rows, dtype=torch.int32,
                                        device="cuda").expand(s, rows).contiguous())
    stray = torch.rand((s, rows), generator=gen, device="cuda") < 0.1
    keys.scatter_(1, free, torch.where(stray, node * 7 + 5, -1).to(torch.int32))
    vals.scatter_(1, free, torch.where(stray, rows + randint(gen, 0, 3, (s, rows)),
                                       -1).to(torch.int32))
    if offset:
        cnt, order = (misaligned(x.to(torch.int32)).view(s, rows, c)
                      for x in (cnt, order))
    return cnt.to(torch.int32), order, tot, dst, keys, vals


def small_topn_windows_checks(gen):
    """The window kernel against its plain mirror at odd small shapes: its
    block lists and counts (``window_lists_cuda`` == ``topn_window_lists_ref``
    at the block count the card picks, so tiles that do not divide N), and
    the whole read == ``topn_windows_ref`` (one block a shard: another
    decomposition of the same answer).  S 1-40, N 1 to 1,000 and 3 tiles
    +- 1 row, C 1 to 1,024, n 1 to 300, counts that tie everywhere, few
    live entries, an empty slab, a shuffled order, src table lanes past the
    rows, slabs 4 B off a 16-B boundary."""
    from repro_torch.kernels import ref, topn_windows as tw
    cases = 0
    shapes = [(1, 1, 1, 1), (1, 37, 16, 8), (3, 37, 3, 5), (4, 1000, 128, 16),
              (8, 1000, 37, 64), (4, 300, 4, 16), (33, 37, 16, 16),
              (40, 10, 4, 16), (2, 50, 1024, 64), (3, 200, 64, 300),
              (4, 3 * 64 + 1, 8, 16), (4, 3 * 64 - 1, 8, 16), (5, 1000, 16, 1)]
    kinds = ("random", "ties", "sparse", "empty", "shuffled")
    for i, (s, rows, c, n) in enumerate(shapes):
        for j, kind in enumerate(kinds):
            if n > rows * min(n, c):
                continue
            offset = (i + j) % 3 == 0 and c % 4 == 0
            cnt, order, tot, dst, keys, vals = topn_state(gen, s, rows, c,
                                                          kind, offset)
            blocks = tw.blocks_for(cnt, n)
            compare(f"topn_windows lists S={s} N={rows} C={c} n={n} {kind} "
                    f"B={blocks}", tw.window_lists_cuda(cnt, order, tot, n=n),
                    ref.topn_window_lists_ref(cnt, order, tot, n, blocks))
            compare(f"topn_windows S={s} N={rows} C={c} n={n} {kind}",
                    tw.topn_windows_cuda(cnt, order, tot, dst, keys, vals, n=n),
                    ref.topn_windows_ref(cnt, order, tot, dst, keys, vals, n))
            cases += 2
    say(f"[kernels] topn_windows: {cases} small cases (lists and counts at the "
        f"card's blocks, and the whole read), S 1-40, N 1-1,000, C 1-1,024, "
        f"n 1-300; equal to the plain mirror")


def parity_sharded(seed, batches=16):
    """The sharded path at S = 4, kernels against plain versions: the owner
    calls with their row flags and the functional callables, every stacked
    leaf after every call, every routed answer and drop count, and the
    top-n at n 8 and 40 equal."""
    from repro_torch import core
    from repro_torch.core import sharded as sh
    base = core.MCConfig(num_rows=512, capacity=32, sort_passes=1,
                         max_new_per_batch=192, decay_block_rows=128, impl="cuda")
    cfgs = {impl: sh.ShardedConfig(base=dataclasses.replace(base, impl=impl),
                                   num_shards=4, bucket_factor=1.0)
            for impl in ("cuda", "ref")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 17)
    own = {impl: (sh.init_sharded(c), torch.zeros((4, base.num_rows),
                                                  dtype=torch.uint8, device="cuda"))
           for impl, c in cfgs.items()}
    fun = {impl: sh.init_sharded(c) for impl, c in cfgs.items()}
    drops = 0
    for i in range(batches):
        src = randint(gen, -1, 900, (1024,))
        hot = randint(gen, 0, 2, (1024,)) == 1
        src = torch.where(hot, src % 24, src)
        dst = (src * 7 + randint(gen, 0, 60, (1024,)) * 13) % 5000
        w = randint(gen, 1, 4, (1024,))
        q = randint(gen, -1, 950, (400,))
        for impl, scfg in cfgs.items():
            st, dirty = own[impl]
            sh.update_(st, src, dst, w, scfg=scfg, dirty=dirty)
            sh.maintain_(st, scfg=scfg, total_threshold=300, dirty=dirty)
            fun[impl] = sh.make_maintain_fn(scfg, 300)(
                sh.make_update_fn(scfg)(fun[impl], src, dst, w))
            if i % 5 == 4:
                sh.decay_(st, scfg=scfg, dirty=dirty)
                fun[impl] = sh.make_decay_fn(scfg)(fun[impl])
        for form, states in (("owner", {k: v[0] for k, v in own.items()}),
                             ("functional", fun)):
            equal_states(f"parity sharded batch {i} {form}", states["cuda"],
                         states["ref"])
        equal_states(f"parity sharded batch {i} owner vs functional",
                     own["cuda"][0], fun["cuda"])
        compare(f"parity sharded batch {i} row flags", own["cuda"][1], own["ref"][1])
        answers = {impl: sh.query(own[impl][0], q, 0.8, 12, scfg=c)
                   for impl, c in cfgs.items()}
        compare(f"parity sharded query batch {i}", answers["cuda"], answers["ref"])
        drops += int(answers["cuda"][3].sum())
        for n in (8, 40):
            compare(f"parity sharded topn n={n} batch {i}",
                    *(sh.topn(own[impl][0], n, scfg=c) for impl, c in cfgs.items()))
    stats = core.counter_stats(own["cuda"][0])
    say(f"[parity] sharded, S=4 at {base.num_rows}x{base.capacity} per shard: "
        f"{batches} batches, every stacked leaf (owner calls and functional "
        f"callables), row flag, routed answer and top-n equal to the plain "
        f"versions'; counters {stats}; query routing drops {drops}")
    for key in ("route_dropped", "evictions", "decay_steps"):
        if stats[key] <= 0:
            raise AssertionError(f"parity sharded stream never exercised {key}")


# ---------------------------------------------------------------------------
# phase 8b: the kill-and-recover soak at phase main's width
# ---------------------------------------------------------------------------

SOAK_KILLS = 8            # one cycle of the soak's KILL_MODES
SOAK_ROWS = NUM_NODES // 2   # 2**19 rows x 16 slots (the soak's capacity):
                             # cut from phase main's 2**20 for the time
SOAK_EVERY = 5            # observes between two background snapshots
SOAK_KERNELS = ("probe_find", "slab_update", "oddeven", "slow_path",
                "decay_sort", "cdf_query_fused",
                "copy_dirty_rows") + TOPN_KERNELS   # the decay decided on
                                                    # the device, not firing


def phase_soak(seed):
    """``repro_torch.chaos.soak.run_soak`` with GPU workers: 8 lives, each
    killed (external SIGKILL, or a self-kill inside ``wal.append.write``,
    ``wal.append.fsync``, ``snapshot.arrays_write``,
    ``snapshot.manifest_commit``), recovered here on the card and held bit
    for bit against a replay oracle; then the last recovered snapshot
    restored on the card and on the CPU, equal; then the path's kernels at
    the soak's shapes against their plain versions."""
    from repro_torch import convert, core
    from repro_torch.chaos import soak
    from repro_torch.core import sharded as sh
    from repro_torch.persist import snapshot as snapshot_io
    per_snapshot = SOAK_ROWS * 16 * 3 * 4 + 2 ** 25
    workdir = persist_dir(40 * per_snapshot, "soak")
    t0 = time.perf_counter()
    with launch_window("soak", SOAK_KERNELS) as launches:
        result = soak.run_soak(SOAK_KILLS, rows=SOAK_ROWS, batch=BATCH,
                               seed=seed, snapshot_every=SOAK_EVERY,
                               workdir=workdir, device="cuda")
    wall = time.perf_counter() - t0
    lives = [r for r in result["rows"] if "kill_mode" in r]
    for k, r in enumerate(lives):
        say(f"[soak] kill {k}: mode {r['kill_mode']}, "
            f"{'killed by its failpoint' if r['armed_death'] else 'SIGKILL'} "
            f"after {r['steps_seen']} steps; durable records {r['steps']}, "
            f"replayed {r['replayed']}; recovery (restore + replay) "
            f"{r['us_per_call'] / 1e3:.1f} ms; oracle replay of every durable "
            f"record {r['oracle_s'] * 1e3:.1f} ms; worker warm-up (imports, "
            f"CUDA context, kernels; "
            + ("cold, its spawn just before the life" if k == 0 else
               "during the life before") + ") "
            + ("not reached" if r["warm_s"] is None else
               f"{r['warm_s'] * 1e3:.1f} ms") + ", "
            f"GO to READY "
            + ("not reached" if r["start_s"] is None else
               f"{r['start_s'] * 1e3:.1f} ms") + " (engine "
            f"{(r['engine_s'] or 0) * 1e3:.1f} ms, its restore "
            + ("none: the base snapshot" if r["restore_s"] is None else
               f"{r['restore_s'] * 1e3:.1f} ms") + ")"
            + ("" if r["bitexact"] else f"; DIVERGED: {r['derived']}"))
    cold = lives[0]["ready_s"]
    say("[soak] a cold worker start (life 0: spawn to READY, with its "
        "imports, CUDA context, kernels and engine): "
        + ("READY not reached" if cold is None else f"{cold * 1e3:.1f} ms"))
    rec = [r["us_per_call"] / 1e3 for r in lives]
    say(f"[soak] {len(lives)} kills at {SOAK_ROWS} rows x 16 slots, batches "
        f"of {BATCH}, a snapshot every {SOAK_EVERY} observes, WAL fsync "
        f"always: recovery mean {statistics.mean(rec):.1f} ms, max "
        f"{max(rec):.1f} ms; all bit-exact {result['ok']}; {wall:.1f} s")
    if not result["ok"] or len(lives) < SOAK_KILLS:
        raise AssertionError(f"soak: {len(lives)} of {SOAK_KILLS} kills "
                             f"completed, all bit-exact {result['ok']}")
    if [r["kill_mode"] for r in lives] != [m or "sigkill"
                                            for m in soak.KILL_MODES]:
        raise AssertionError("soak: the lives did not run one cycle of "
                             "KILL_MODES")
    # a failpoint not reached within MAX_STEPS_PER_LIFE ends in a SIGKILL
    # from outside while its life still names the failpoint
    wrong = [(k, r["kill_mode"]) for k, r in enumerate(lives)
             if r["armed_death"] != (r["kill_mode"] != "sigkill")]
    if wrong:
        raise AssertionError(f"soak: lives not ended by their kill mode "
                             f"(failpoint lives by the failpoint, the others "
                             f"by SIGKILL): {wrong}")

    # the newest complete snapshot, restored on the card and on the CPU
    engines = {}
    for device in ("cuda", "cpu"):
        engines[device] = soak._build_engine(workdir, SOAK_ROWS, device=device)
        info = engines[device].restore(replay=False)
    card, cpu = (published(engines[d]) for d in ("cuda", "cpu"))
    equal_states("soak: the last snapshot restored on the card vs the CPU",
                 card, on_card(cpu))
    engines["cpu"].close()
    # the WAL tail replayed on the card gives the state the soak verified
    step = snapshot_io.latest_complete_step(os.path.join(workdir, "snap"))
    t0 = time.perf_counter()
    engines["cuda"].restore()
    replay_ms = (time.perf_counter() - t0) * 1e3
    state = published(engines["cuda"])
    say(f"[soak] snapshot step {step} ({info['mode']}, wal_seq "
        f"{info['wal_seq']}) restored on the card and on the CPU: all "
        f"{len(convert.LEAF_NAMES)} leaves equal; on the card with its WAL "
        f"tail {replay_ms:.1f} ms; counters {core.counter_stats(state)}")

    # the path's kernels at the soak's shapes: shard 0 of the recovered
    # state, one more batch of the stream, the probe query's srcs
    scfg = engines["cuda"].cfg.sharded
    src, dst = (torch.from_numpy(x).cuda() for x in
                soak.batch_for(seed, engines["cuda"]._seq + 1, SOAK_ROWS, BATCH))
    q = torch.arange(QUERIES, dtype=torch.int32, device="cuda")
    entries = path_shape_kernels(sh.shard_state(state, 0), scfg.base, src, dst,
                                 q, launches, path="soak", reads=((0.9, 16),),
                                 unfused=False)
    # the catch-up at the soak's shapes: one more observe through the
    # recovered engine's learner leaves the flags the next write copies
    engines["cuda"].observe(*soak.batch_for(seed, engines["cuda"]._seq + 2,
                                            SOAK_ROWS, BATCH))
    learner_catch_up_entry(entries, launches, "copy_dirty_rows[soak]",
                           engines["cuda"]._writer)
    engines["cuda"].close()
    del engines, state, card, cpu
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phase 8c: the three chain examples on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("telecom_paging", "recommender_sessions", "quickstart",
            "lm_speculative_serve")
EXAMPLE_MASKS = (   # what differs from run to run: timings, a process id
    (r'(mcq_engine_\w+_seconds\{quantile="[0-9.]+"\}) \S+', r"\1 <seconds>"),
    (r"incident_(\d+)_\d+\.json", r"incident_\1_<pid>.json"),
    # the LM example trains in bfloat16, whose rounding differs on the card
    # from the CPU's: its losses, and so the tokens the drafter learns and
    # how many it drafts right; the token count is not masked
    (r"loss \S+ gnorm \S+ \(\S+s/step\)", "loss <loss> gnorm <gnorm> (<s>/step)"),
    (r"loss: \S+ -> \S+", "loss: <first> -> <last>"),
    (r"tokens in \S+s \(\S+ tok/s\), model calls \d+ vs (\d+) plain "
     r"\(\S+x\), draft acceptance \S+%",
     r"tokens in <s> (<tok/s>), model calls <calls> vs \1 plain (<ratio>), "
     r"draft acceptance <acceptance>"),
)
#: threads of each example's process: eight share the host's cores with
#: phase parity's checks; the LM example's runs take 4 (at 8 its CPU run
#: slowed the checks beside it by half)
EXAMPLE_THREADS = {"lm_speculative_serve": "4"}
LM_EXAMPLE_PLAIN_CALLS = 6 * 47   # plain greedy's model calls, 6 requests
LM_EXAMPLE_LOSS_STEPS = 10        # the first logged loss


def lm_example_loss_bound():
    """The card-vs-CPU bound of the LM example's first logged loss (step
    10), from the CPU's own rounding: the example's training run on the CPU
    in process at its bfloat16 compute and again at float32, the same
    parameters and batches; the bound is the larger of 2e-3 (the CPU tests'
    bound against the reference launcher) and twice the largest |bfloat16 -
    float32| loss over the 10 steps, as phase lm's one rule bounds a
    logit."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as t_train
    losses = {}
    real, threads = t_train.smoke_config, torch.get_num_threads()
    torch.set_num_threads(2)   # beside the examples' processes
    try:
        for dtype in ("bfloat16", "float32"):
            t_train.smoke_config = lambda a, d=dtype: dataclasses.replace(
                smoke_config(a), dtype=d)
            losses[dtype] = np.array(t_train.run(
                "starcoder2-3b", smoke=True, steps=LM_EXAMPLE_LOSS_STEPS,
                batch=8, seq=128, ckpt_dir=None, log_every=1_000,
                device="cpu"))
    finally:
        t_train.smoke_config = real
        torch.set_num_threads(threads)
    spread = float(np.abs(losses["bfloat16"] - losses["float32"]).max())
    return max(2e-3, 2 * spread), spread


def phase_examples():
    """``examples/torch_*.py`` as a user runs them, on the card (their
    default device), and again with ``--device cpu``, all eight at once:
    each exits 0, and every line a run prints (timings and a process id
    masked; the LM example's losses, rates, acceptance and model calls) is
    the same on the card as on the CPU.  The LM example (trains 300 steps
    into a fresh checkpoint directory of its own, then serves with the
    drafter): its loss falls on both (the example asserts it), the card's
    model calls are at most plain greedy's, and its first logged loss on
    the card is within ``lm_example_loss_bound`` of the CPU's.  Starts the
    eight runs and returns a function that waits for them and checks them:
    phase parity's equality checks (no timing) run on the host meanwhile."""
    import re
    import threading
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(root / "src"),
                                         env.get("PYTHONPATH", "")])
    runs, done = {}, {}

    env["OMP_NUM_THREADS"] = "2"   # six processes share the host's cores

    def run(name, device):
        args = [sys.executable, str(root / "examples" / f"torch_{name}.py")]
        t0 = time.perf_counter()
        proc = subprocess.run(args + (["--device", "cpu"] if device == "cpu"
                                      else []),
                              cwd=root, env=dict(env, OMP_NUM_THREADS=(
                                  EXAMPLE_THREADS.get(name, "2"))),
                              capture_output=True, text=True, timeout=900)
        done[(name, device)] = time.perf_counter() - t0
        runs[(name, device)] = proc

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(name, device))
               for name in EXAMPLES for device in ("cuda", "cpu")]
    for t in threads:
        t.start()
    t_bound = time.perf_counter()
    loss_bound, loss_spread = lm_example_loss_bound()
    t_bound = time.perf_counter() - t_bound
    return lambda: finish_examples(threads, t0, runs, done, loss_bound,
                                   loss_spread, t_bound)


def finish_examples(threads, t0, runs, done, loss_bound, loss_spread,
                    t_bound):
    """Wait for phase examples' runs; every check on their output."""
    import re
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for (name, device), proc in sorted(runs.items()):
        if proc.returncode != 0:
            raise AssertionError(f"examples/torch_{name}.py on {device} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")

    def masked(text):
        for pattern, repl in EXAMPLE_MASKS:
            text = re.sub(pattern, repl, text)
        return text.splitlines()

    for name in EXAMPLES:
        card, cpu = (masked(runs[(name, d)].stdout) for d in ("cuda", "cpu"))
        if card != cpu or len(card) < 5:
            diff = [(a, b) for a, b in zip(card, cpu) if a != b][:3]
            raise AssertionError(f"examples/torch_{name}.py prints other "
                                 f"lines on the card than on the CPU: {diff}")
        say(f"[examples] torch_{name}.py: exit 0 on the card in "
            f"{done[(name, 'cuda')]:.1f} s and on the CPU in "
            f"{done[(name, 'cpu')]:.1f} s (all eight at once); its "
            f"{len(card)} lines equal")
        for line in runs[(name, "cuda")].stdout.splitlines():
            say(f"[examples]   {line}")
    lm_example_checks(runs, loss_bound, loss_spread, t_bound)
    say(f"[examples] {len(EXAMPLES)} examples on the card and on the CPU in "
        f"{wall:.1f} s (phase parity's equality checks beside them)")


def lm_example_checks(runs, bound, spread, bound_s):
    """The LM example's numbers the masks hid: the card's model calls at
    most plain greedy's; its first logged loss against the CPU's."""
    import re
    out = {d: runs[("lm_speculative_serve", d)].stdout for d in ("cuda", "cpu")}
    calls = re.search(r"model calls (\d+) vs (\d+) plain", out["cuda"])
    if calls is None or int(calls.group(2)) != LM_EXAMPLE_PLAIN_CALLS or \
            int(calls.group(1)) > LM_EXAMPLE_PLAIN_CALLS:
        raise AssertionError(f"the LM example's model calls on the card: "
                             f"{calls and calls.group(0)}")
    first = {}
    for d, text in out.items():
        m = re.search(rf"step +{LM_EXAMPLE_LOSS_STEPS} loss (\S+)", text)
        if m is None:
            raise AssertionError(f"the LM example on {d} logged no step "
                                 f"{LM_EXAMPLE_LOSS_STEPS} loss")
        first[d] = float(m.group(1))
    diff = abs(first["cuda"] - first["cpu"])
    if diff > bound:
        raise AssertionError(f"the LM example's step-{LM_EXAMPLE_LOSS_STEPS} "
                             f"loss: card {first['cuda']} vs CPU "
                             f"{first['cpu']}, |difference| {diff} > bound "
                             f"{bound}")
    say(f"[examples] torch_lm_speculative_serve.py: model calls on the card "
        f"{calls.group(1)} <= plain greedy's {LM_EXAMPLE_PLAIN_CALLS}; its "
        f"step-{LM_EXAMPLE_LOSS_STEPS} loss {first['cuda']:.4f} on the card, "
        f"{first['cpu']:.4f} on the CPU: |difference| {diff:.4f} <= bound "
        f"{bound:.4f} (max(2e-3, 2 x the CPU's own largest |bfloat16 - "
        f"float32| loss over {LM_EXAMPLE_LOSS_STEPS} steps, {spread:.4f}), "
        f"measured in process in {bound_s:.1f} s")


# ---------------------------------------------------------------------------
# more shards than one warp's lists, kernels vs plain versions
# ---------------------------------------------------------------------------

MANY_SHARDS = 40          # the engine: S > 25 (the catch-up's old limit)
MANY_LISTS = 64           # the merge alone: two groups of 32 lists, one launch


def parity_many_shards(seed):
    """Engines of ``MANY_SHARDS`` shards, one with the kernels and one with
    the plain versions: every stacked leaf after every observe, the routed
    answers and the top-16 equal, and the top-16 equal to a stable host
    sort of every shard's live edges; the stacked catch-up over S·10
    scalars and the merge of 33, 40 and 64 lists (ties, NaN, zero and
    negative heads, lists shorter than n) equal to their plain versions;
    a 64-shard top-16.  Returns the kernel entries
    ``copy_dirty_rows[S=40]``, ``topn_merge[S=40]`` and
    ``topn_merge[S=64]``."""
    from repro_torch import core
    from repro_torch.core import epoch
    from repro_torch.core import sharded as sh
    from repro_torch.core.hashtable import EMPTY
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.engine import ShardedEngine, ShardedServeConfig
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 41)
    rng = np.random.default_rng(seed + 41)
    base = dict(num_rows=256, capacity=16, sort_passes=2, decay_block_rows=64)
    s = MANY_SHARDS
    engines = {impl: ShardedEngine(ShardedServeConfig(
        sharded=sh.ShardedConfig(base=core.MCConfig(**base, impl=impl),
                                 num_shards=s, bucket_factor=4.0),
        decay_threshold=48)) for impl in ("cuda", "ref")}
    with launch_window(f"parity engine S={s}",
                       ("copy_dirty_rows",) + TOPN_KERNELS) as launches:
        for i in range(12):
            src = rng.integers(0, 6 * s, 32 * s).astype(np.int32)
            dst = rng.integers(0, 40, src.size).astype(np.int32)
            for engine in engines.values():
                engine.observe(src, dst)
            equal_states(f"parity S={s} engine observe {i}",
                         *(published(e) for e in engines.values()))
            q = rng.integers(-1, 7 * s, 8 * s).astype(np.int32)
            compare(f"parity S={s} engine query {i}",
                    *(e.query(q) for e in engines.values()))
            tops = [e.topn(16) for e in engines.values()]
            compare(f"parity S={s} engine top-16 {i}", *tops)
            host = host_topn(published(engines["cuda"]), 16)
            for got, want in zip(tops[0], host[:3]):
                if not np.array_equal(got.cpu().numpy(), np.asarray(want)):
                    raise AssertionError(f"parity S={s} engine top-16 {i} "
                                         f"differs from a host sort")
    stats = core.counter_stats(published(engines["cuda"]))
    if stats["decay_steps"] <= 0 or stats["evictions"] <= 0:
        raise AssertionError(f"parity S={s} engine never decayed: {stats}")
    say(f"[parity] engine at S={s} x {base['num_rows']} rows x "
        f"{base['capacity']} slots: 12 observes, every stacked leaf, query "
        f"and top-16 equal to the plain versions', the top-16 to a stable "
        f"host sort; counters {stats}")

    entries = []
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    learner_catch_up_entry(entries, launches, f"copy_dirty_rows[S={s}]",
                           engines["cuda"]._writer, extra=dict(shards=s))

    def merge_entry(label, probs, dsts, srcs, n, launches):
        from repro_torch.kernels import topn_merge
        lists, m = probs.shape
        before = topn_merge.launches
        merged = ops.topn_merge(probs, dsts, srcs, n=n, impl="cuda")
        per_call = topn_merge.launches - before
        if per_call != 1:    # up to 1,024 lists at n <= 256 take one
            raise AssertionError(f"{label}: {per_call} launches for {lists} "
                                 f"lists")
        winners = int((merged[2] > 0).sum())

        def library():
            v, i = torch.sort(probs.view(-1), descending=True, stable=True)
            v, i = v[:n], i[:n]
            live = v > 0
            return (torch.where(live, srcs.view(-1)[i], EMPTY),
                    torch.where(live, dsts.view(-1)[i], EMPTY),
                    torch.where(live, v, 0.0))

        kernel_entry(entries, launches, flush, label, "topn_merge",
                     "topn_merge.cu", "src/repro/kernels/ref.py:185",
                     lambda impl: ops.topn_merge(probs, dsts, srcs, n=n,
                                                 impl=impl),
                     # the flat merge: the S first heads and the head each
                     # step advances to, the winners' srcs and dsts, the n
                     # outputs; an S-way comparison per step
                     bytes_moved=4 * (lists + n) + 8 * winners + 12 * n,
                     operations=4 * n * lists, library=library,
                     extra=dict(lists=lists, length=m,
                                launches_per_call=per_call,
                                live_winners=winners))

    merge_entry(f"topn_merge[S={s}]", *sh.topn_lists(
        published(engines["cuda"]), 16, scfg=engines["cuda"].cfg.sharded)[:3],
        16, launches)
    for engine in engines.values():
        engine.close()
    del engines

    # the merge alone at 33, 40 and 64 lists, any input
    cases = 0
    for lists in (33, 40, MANY_LISTS):
        for m, n in ((5, 16), (16, 16), (3, 200), (40, 7)):
            for kind in ("descending", "unsorted", "nan"):
                probs = randint(gen, 0, 6, (lists, m)).float() / 8
                if kind == "descending":
                    probs = torch.sort(probs, dim=1, descending=True).values
                    probs[:, m // 2 + 1:] = 0.0
                elif kind == "nan":
                    r = torch.rand((3, lists, m), generator=gen, device="cuda")
                    probs[r[0] < 0.1] = float("nan")
                    probs[r[1] < 0.2] = -0.0
                    probs[r[2] < 0.1] = -0.5
                live = probs > 0
                dsts = torch.where(live, randint(gen, 0, 500, (lists, m)), -1
                                   ).to(torch.int32)
                srcs = torch.where(live, randint(gen, 0, 500, (lists, m)), -1
                                   ).to(torch.int32)
                got = ops.topn_merge(probs, dsts, srcs, n=n, impl="cuda")
                compare(f"topn_merge S={lists} M={m} n={n} {kind}", got,
                        ops.topn_merge(probs, dsts, srcs, n=n, impl="ref"))
                compare(f"topn_merge S={lists} M={m} n={n} {kind} (rounds)",
                        got, ref.topn_merge_rounds_ref(probs, dsts, srcs, n))
                cases += 1
    say(f"[parity] topn_merge: {cases} cases at 33, 40 and {MANY_LISTS} lists "
        f"(one launch, two levels), equal to the flat plain version and the "
        f"mirror of its launches")

    # a 64-shard chain's top-16 through the window kernel, on the path
    scfg = sh.ShardedConfig(base=core.MCConfig(num_rows=64, capacity=8,
                                               sort_passes=2),
                            num_shards=MANY_LISTS, bucket_factor=4.0)
    state = sh.init_sharded(scfg)
    with launch_window(f"parity top-16 at S={MANY_LISTS}",
                       TOPN_KERNELS) as launches:
        for _ in range(4):
            src = randint(gen, 0, 4 * MANY_LISTS, (16 * MANY_LISTS,))
            dst = randint(gen, 0, 30, (16 * MANY_LISTS,))
            sh.update_(state, src, dst, torch.ones_like(src), scfg=scfg)
            got = sh.topn(state, 16, scfg=scfg)
            host = host_topn(state, 16)
            for a, b in zip(got[:3], host[:3]):
                if not np.array_equal(a.cpu().numpy(), np.asarray(b)):
                    raise AssertionError(f"top-16 at S={MANY_LISTS} differs "
                                         f"from a host sort")
    merge_entry(f"topn_merge[S={MANY_LISTS}]",
                *sh.topn_lists(state, 16, scfg=scfg)[:3], 16, launches)
    say(f"[parity] top-16 of a {MANY_LISTS}-shard chain equal to a stable host "
        f"sort after each of 4 updates")
    return entries


# ---------------------------------------------------------------------------
# phase 9: the whole path, kernels vs plain versions, on the card
# ---------------------------------------------------------------------------


def equal_states(label, a, b):
    """Every one of the 18 leaves of two chains equal (on the device)."""
    from repro_torch import convert
    for name in convert.LEAF_NAMES:
        x, y = a, b
        for part in name.split("."):
            x, y = getattr(x, part), getattr(y, part)
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: leaf {name} differs")


#: batches of the chains held kernel-vs-plain in phase parity, at most: the
#: plain chain cut from 32 for the script's time; the dst-hash chain keeps
#: 32, room for its stream to reach a rebuild of its row hashes.  Each
#: stream ends early once past its mid-stream decay every counter it must
#: exercise has fired (a cut of depth, ``parity_chain``)
PARITY_BATCHES, PARITY_HASH_BATCHES = 16, 32
PARITY_SHARDED_BATCHES = 6     # the sharded chain and the reshard, from 8
                               # (a decay_ fires at the fifth)


def phase_parity(seed, batches=PARITY_BATCHES, beside=None):
    """The whole path kernels against plain versions at a small
    configuration.  ``beside``: called once the equality checks are done
    and before the timed kernel entries of ``parity_many_shards`` (phase
    examples' processes run beside the checks, and end first)."""
    from repro_torch import core
    cfg = core.MCConfig(num_rows=512, capacity=32, sort_passes=1,
                        max_new_per_batch=192, decay_block_rows=128,
                        impl="cuda")
    # the dst hash: row hashes of 64 lanes, a rebuild once 2 % are tombstones
    hashed = dataclasses.replace(cfg, use_dst_hash=True, dst_table_size=64,
                                 max_probes=16, dh_rebuild_fraction=0.02)
    for name, part in (
            ("chain", lambda: parity_chain(seed, cfg, batches, "parity")),
            ("hash", lambda: parity_chain(seed + 3, hashed,
                                          PARITY_HASH_BATCHES,
                                          "parity/hash")),
            ("learner", lambda: parity_learner(seed, hashed)),
            ("drafter", lambda: parity_drafter(seed)),
            ("sharded", lambda: parity_sharded(seed,
                                               PARITY_SHARDED_BATCHES)),
            ("reshard", lambda: parity_reshard(seed,
                                               PARITY_SHARDED_BATCHES)),
            ("engine", lambda: parity_engine(seed))):
        t0 = time.perf_counter()
        part()
        took(f"parity {name}", t0)
    if beside is not None:
        beside()
    t0 = time.perf_counter()
    entries = parity_many_shards(seed)
    took("parity many shards", t0)
    return entries


def parity_chain(seed, cfg_k, batches, label):
    """One chain stream, once with the CUDA kernels and once with the plain
    versions: every state leaf equal after every batch, functional and
    owner calls (with their row flags), fused and unfused answers equal.
    At most ``batches`` batches: the stream stops after the first batch
    past its mid-stream ``decay`` at which every counter it must exercise
    (and, with the dst hash, a held tombstone) has fired."""
    from repro_torch import convert, core
    cfg_p = dataclasses.replace(cfg_k, impl="ref")
    unfused = [dataclasses.replace(c, fused_query=False, query_chunks=ch)
               for c, ch in ((cfg_k, 0), (cfg_p, 2))]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    sk, sp = core.init(cfg_k), core.init(cfg_p)
    # the owner calls, kernels and plain versions, with their row flags
    own = {cfg.impl: (core.init(cfg), torch.zeros(cfg.num_rows, dtype=torch.uint8,
                                                  device="cuda"))
           for cfg in (cfg_k, cfg_p)}
    nodes, degree, size = 700, 96, 512
    most_tombs = 0
    need = ["deferred_new", "evictions", "dropped_rows", "decay_steps"]
    if cfg_k.use_dst_hash:
        need.append("dh_rebuilds")

    def exercised():
        stats = core.counter_stats(sk)
        return all(stats[key] > 0 for key in need) and (
            most_tombs > 0 or not cfg_k.use_dst_hash)

    for i in range(batches):
        src = randint(gen, -2, nodes, (size,))          # a few negative ids
        hot = randint(gen, 0, 2, (size,)) == 1          # half on 16 hot nodes:
        src = torch.where(hot, src % 16, src)           # their rows overflow
        rank = randint(gen, 0, degree, (size,)) * randint(gen, 0, 2, (size,))
        dst = (src * 7 + rank * 13) % 5000
        w = randint(gen, 1, 4, (size,))
        mask = torch.rand(size, generator=gen, device="cuda") < 0.9
        sk = core.update_batch(sk, src, dst, w, mask, cfg=cfg_k)
        sp = core.update_batch(sp, src, dst, w, mask, cfg=cfg_p)
        sk = core.maybe_decay(sk, cfg=cfg_k, total_threshold=400)
        sp = core.maybe_decay(sp, cfg=cfg_p, total_threshold=400)
        for cfg in (cfg_k, cfg_p):
            st, dirty = own[cfg.impl]
            core.update_batch_(st, src, dst, w, mask, cfg=cfg, dirty=dirty)
            core.maybe_decay_(st, cfg=cfg, total_threshold=400, dirty=dirty)
        if i == batches // 2:
            sk, sp = core.decay(sk, cfg=cfg_k), core.decay(sp, cfg=cfg_p)
            for cfg in (cfg_k, cfg_p):
                core.decay_(own[cfg.impl][0], cfg=cfg, dirty=own[cfg.impl][1])
        equal_states(f"{label} batch {i}", sk, sp)
        equal_states(f"{label} batch {i}: owner calls (kernels)", own["cuda"][0], sp)
        equal_states(f"{label} batch {i}: owner calls (plain)", own["ref"][0], sp)
        compare(f"{label} batch {i}: row flags", own["cuda"][1], own["ref"][1])
        most_tombs = max(most_tombs, int(sk.dh_tombstones))
        q = randint(gen, 0, nodes + 50, (300,))
        fused = core.query_threshold(sk, q, 0.8, cfg=cfg_k, max_items=12)
        fused_top = core.query_topk(sk, q, cfg=cfg_k, k=5)
        compare(f"{label} query_threshold batch {i}", fused,
                core.query_threshold(sp, q, 0.8, cfg=cfg_p, max_items=12))
        compare(f"{label} query_topk batch {i}", fused_top,
                core.query_topk(sp, q, cfg=cfg_p, k=5))
        # the unfused read, kernel and plain version, against the fused one
        for cfg_u, st in zip(unfused, (sk, sp)):
            compare(f"{label} unfused query_threshold {cfg_u.impl} batch {i}",
                    core.query_threshold(st, q, 0.8, cfg=cfg_u, max_items=12),
                    fused)
            compare(f"{label} unfused query_topk {cfg_u.impl} batch {i}",
                    core.query_topk(st, q, cfg=cfg_u, k=5), fused_top)
        if i > batches // 2 and exercised():
            break
    stats = core.counter_stats(sk)
    say(f"[{label}] {i + 1} of up to {batches} batches at "
        f"{cfg_k.num_rows}x{cfg_k.capacity}"
        + (f", row hashes of {cfg_k.resolved_dst_table_size()} lanes"
           if cfg_k.use_dst_hash else "")
        + f": all {len(convert.LEAF_NAMES)} state leaves and all query "
        f"answers, fused and unfused, equal after every batch, and the owner "
        f"calls' states and row flags ({int(own['cuda'][1].sum())} rows "
        f"flagged) too; counters {stats}; most tombstones held {most_tombs}")
    if cfg_k.use_dst_hash:
        if most_tombs <= 0:
            raise AssertionError(f"{label}: no decay ever left a tombstone")
    for key in need:
        if stats[key] <= 0:
            raise AssertionError(f"{label} stream never exercised {key}")
    inv = core.check_invariants(sk, cfg_k)
    if not all(v for k, v in inv.items() if k != "sorted_fraction"):
        raise AssertionError(f"{label}: invariants violated: {inv}")


def parity_learner(seed, cfg, writes=16):
    """The back-buffer learner on a chain with the dst hash, its writes
    launching the kernels, against the functional calls with the plain
    versions: every leaf of each published state equal."""
    from repro_torch import core
    from repro_torch.core.epoch import BackBufferLearner, EpochStore
    cfg_p = dataclasses.replace(cfg, impl="ref")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 5)
    learner = BackBufferLearner(EpochStore(core.init(cfg)))
    functional = core.init(cfg_p)
    for i in range(writes):
        src = randint(gen, 0, 150, (512,))
        dst = (src * 5 + randint(gen, 0, 60, (512,))) % 3000
        functional = core.maybe_decay(core.update_batch(
            functional, src, dst, cfg=cfg_p), cfg=cfg_p, total_threshold=8)
        published = learner.write(
            lambda s, dirty, table_dirty: core.maybe_decay_(
                core.update_batch_(s, src, dst, cfg=cfg, dirty=dirty,
                                   table_dirty=table_dirty),
                cfg=cfg, total_threshold=8, dirty=dirty))
        equal_states(f"parity learner write {i}", published, functional)
    stats = core.maintenance_stats(functional)
    say(f"[parity] back-buffer learner with row hashes: {writes} writes equal "
        f"to the functional calls' states, every leaf; {stats}")
    if stats["decay_steps"] <= 0 or stats["dh_rebuilds"] <= 0:
        raise AssertionError(f"parity learner never decayed and rebuilt: {stats}")


def parity_drafter(seed, batches=24):
    """A small drafter stream, kernels vs plain versions: every state leaf,
    every draft and every candidate set equal after every batch."""
    from repro_torch import core
    from repro_torch.core import speculative as spec
    ncfg_k = spec.NGramConfig(order=2, decay_threshold=40, mc=core.MCConfig(
        num_rows=256, capacity=8, sort_passes=1, max_new_per_batch=96,
        decay_block_rows=64, impl="cuda"))
    ncfg_p = dataclasses.replace(ncfg_k, mc=dataclasses.replace(ncfg_k.mc,
                                                                impl="ref"))
    traffic = TokenTraffic(seed + 2, vocab=60)
    sk, sp = spec.init(ncfg_k), spec.init(ncfg_p)
    drafted = 0
    for i in range(batches):
        toks = traffic.batch(seqs=8, length=65)
        sk = spec.maintain(spec.observe(sk, toks, cfg=ncfg_k), cfg=ncfg_k)
        sp = spec.maintain(spec.observe(sp, toks, cfg=ncfg_p), cfg=ncfg_p)
        equal_states(f"parity drafter batch {i}", sk.chain, sp.chain)
        ctx = traffic.contexts(toks, n=200, width=4, unknown=0.1)
        for k in (1, 4):
            got = spec.draft(sk, ctx, cfg=ncfg_k, k=k)
            compare(f"parity draft k={k} batch {i}", got,
                    spec.draft(sp, ctx, cfg=ncfg_p, k=k))
            compare(f"parity draft_reference k={k} batch {i}", got,
                    spec.draft_reference(sk, ctx, cfg=ncfg_k, k=k))
            drafted += int(got[1].sum())
        compare(f"parity candidates batch {i}",
                spec.candidates(sk, ctx, 0.9, cfg=ncfg_k, max_items=6),
                spec.candidates(sp, ctx, 0.9, cfg=ncfg_p, max_items=6))
    stats = core.counter_stats(sk.chain)
    say(f"[parity] drafter: {batches} batches at {ncfg_k.mc.num_rows}x"
        f"{ncfg_k.mc.capacity}: every state leaf, draft and candidate set "
        f"equal after every batch; {drafted} ok draft steps; counters {stats}")
    for need in ("evictions", "decay_steps"):
        if stats[need] <= 0:
            raise AssertionError(
                f"parity drafter stream never exercised {need}: {stats}")
    if drafted == 0:
        raise AssertionError("parity drafter stream never drafted a token")


# ---------------------------------------------------------------------------
# phase lm: the LM serving path, Engine + MCPrioQ drafter, at full width
# ---------------------------------------------------------------------------

#: the archs served at full width: the dense family (the reference
#: launcher's default arch) and one of each family of queue A 8d that fits
#: one 80 GB card (moonshot-v1-16b-a3b, 113.6 GB of float32, does not)
LM_ARCHS = ("qwen2-7b", "deepseek-moe-16b", "mamba2-130m", "recurrentgemma-9b")
LM_LAUNCHER_ARCH = "mamba2-130m"   # the launcher check: the smallest, a cut
                                   # of depth (every arch is served in process)
LM_REQUESTS, LM_BATCH, LM_PROMPT, LM_NEW = 3, 2, 64, 24   # 3, 24: cuts of depth
LM_DRAFT = 4             # the reference launcher's --draft-len
LM_LOGIT_TOL = {          # |card - CPU| of a logit at depth 2, by dtype; a
    "float32": 0.01,       # wrong computation moves a logit by about its
    "bfloat16": 0.25,      # size (4-5); random attention scores of +-100
}                          # amplify a sum's order (8 bf16 ulps at [4, 8))
LM_MEAN_TOL = {           # the mean |card - CPU| of a call's logits, by dtype
    "float32": 0.001,
    "bfloat16": 0.15,      # the CPU tests' mean bound
}
LM_ROUNDING_RATIO = 4     # the card's |bfloat16 - float32| against the CPU's
LM_KERNELS = ("draft_walk", "probe_find", "slab_update", "oddeven",
              "decay_sort", "slow_path", "copy_dirty_rows")
#: the encoder and patch-prefix archs: the reference's launcher and its
#: Engine feed neither frames nor prefix embeddings, so they run through
#: ``Model`` (prefill, greedy decodes, an extension == its decodes)
LM_MODEL_ARCHS = ("whisper-base", "phi-3-vision-4.2b")
LM_FRAMES = 1500         # whisper's 30 s window (arXiv:2212.04356), stub frames


def lm_config(arch, layers=None):
    """``arch`` at its published widths (``layers`` cuts its depth, the
    encoder's too)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    enc = {"encoder_layers": layers} if cfg.encoder_layers else {}
    return dataclasses.replace(cfg, num_layers=layers, **enc)


def lm_prefix_len(cfg):
    """Positions the stub frontend puts before the text (``vlm``)."""
    return cfg.frontend_len if cfg.frontend == "patch" else 0


def lm_extra(cfg, seed, batch=LM_BATCH, frames=LM_FRAMES):
    """The stub frontend's inputs, normal draws from a seeded generator on
    the CPU (so the card and the CPU get the same values): whisper's
    frames [batch, frames, d], phi-3-vision's patch embeddings [batch,
    frontend_len, d]; nothing for a text arch."""
    gen = torch.Generator().manual_seed(seed + 13)
    if cfg.encoder_layers:
        return {"frames": torch.randn((batch, frames, cfg.d_model),
                                      generator=gen)}
    if cfg.frontend == "patch":
        return {"prefix_embeds": torch.randn(
            (batch, cfg.frontend_len, cfg.d_model), generator=gen)}
    return {}


def on(extra, dev):
    return {k: v.to(dev) for k, v in extra.items()}


def lm_check_layers(arch):
    """Depth of the card-against-CPU check: 2 layers, or one whole period
    with the leading dense layers (recurrentgemma: rglru, rglru,
    local_attn), so every layer kind of the arch runs."""
    cfg = lm_config(arch)
    return max(2, cfg.first_dense_layers + len(cfg.pattern))


def lm_serve_config(draft_len):
    """The reference launcher's ``run()`` sizes
    (``src/repro/launch/serve.py:57-66``) at this phase's lengths."""
    from repro_torch.core import mcprioq as mc
    from repro_torch.core import speculative as spec
    from repro_torch.serve.engine import ServeConfig
    return ServeConfig(
        max_new_tokens=LM_NEW, max_cache_len=LM_PROMPT + LM_NEW + 8,
        draft_len=draft_len, ngram=spec.NGramConfig(
            order=2, decay_threshold=1 << 18, mc=mc.MCConfig(
                num_rows=8192, capacity=64, sort_passes=1,
                decay_block_rows=1024)))


def lm_prompts(seed, vocab):
    """LM_REQUESTS prompts of 2 x 64 tokens: a random one, the same one
    again (the drafter has learned its continuation: drafts accepted
    whole), that one with its last 8 tokens replaced (drafts accepted in
    part); a new random fourth one is left out, a cut of depth."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        return rng.integers(0, vocab, shape).astype(np.int32)

    first = draw((LM_BATCH, LM_PROMPT))
    edited = first.copy()
    edited[:, -8:] = draw((LM_BATCH, 8))
    return [first, first.copy(), edited,
            draw((LM_BATCH, LM_PROMPT))][:LM_REQUESTS]


def lm_serve(model, params, draft_len, prompts):
    """The prompts through a fresh ``Engine``, one request each, as a user
    calls it.  Returns (tokens [R, B, N], engine, the histories handed to
    ``_learn``, ms per ``_learn``, wall seconds)."""
    from repro_torch.serve.engine import Engine
    engine = Engine(model, params, lm_serve_config(draft_len))
    histories, learn_ms = [], []
    learn = engine._learn

    def recorded(history):
        histories.append(np.array(history, copy=True))
        t0 = time.perf_counter()
        learn(history)          # ends in host reads of the published state
        learn_ms.append((time.perf_counter() - t0) * 1e3)

    engine._learn = recorded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = np.stack([engine.generate({"tokens": p}) for p in prompts])
    torch.cuda.synchronize()
    return outs, engine, histories, learn_ms, time.perf_counter() - t0


def lm_model_ms(model, params, prompt, extra=None):
    """Milliseconds per prefill, decode_step and extend_step (4 tokens) at
    the served shapes: the latency a caller waits, by events on an idle
    device (medians of 5).  A full-width step launches thousands of
    kernels, more than the launch queue holds, so a spin kernel ahead of it
    cannot hide the host: the device's busy time comes from ``--profile``.
    Also holds the lossless mechanism directly: the 4-token extension's
    logits and caches == 4 decode steps', bit for bit, and a ``cross``
    block's ``mem_k``/``mem_v`` as the prefill wrote them.  ``extra``: the
    stub frontend's inputs (on the card)."""
    from repro_torch.serve import sampling
    npre = lm_prefix_len(model.cfg)
    max_len = npre + LM_PROMPT + LM_NEW + 8
    batch = {"tokens": torch.as_tensor(prompt, device="cuda"), **(extra or {})}
    tokens = batch["tokens"]
    logits, caches = model.prefill(params, batch, max_len)
    cur = sampling.greedy(logits)[:, None]
    pos = torch.full((LM_BATCH,), npre + LM_PROMPT, dtype=torch.int32,
                     device="cuda")
    feed = torch.cat([cur, tokens[:, :LM_DRAFT - 1]], dim=1)
    ext, ext_caches = model.extend_step(params, caches, feed, pos)
    steps, c = [], caches
    for j in range(LM_DRAFT):
        step, c = model.decode_step(params, c, feed[:, j:j + 1], pos + j)
        steps.append(step)
    got, want = tensor_leaves(ext_caches), tensor_leaves(c)
    if not torch.equal(ext, torch.stack(steps, dim=1)) or \
            len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"lm {model.cfg.name}: a {LM_DRAFT}-token "
                             f"extension differs from {LM_DRAFT} decode "
                             f"steps on the card")
    for before, after in zip(memory_leaves(caches), memory_leaves(ext_caches)):
        if not torch.equal(before, after):
            raise AssertionError(f"lm {model.cfg.name}: an extension wrote "
                                 f"the encoder memory's projection")
    del ext_caches, c, steps
    calls = {
        "prefill": lambda: model.prefill(params, batch, max_len),
        "decode_step": lambda: model.decode_step(params, caches, cur, pos),
        f"extend_step[{LM_DRAFT}]": lambda: model.extend_step(
            params, caches, feed, pos),
    }
    return {k: time_ms(fn, reps=5, warm=1) for k, fn in calls.items()}


def memory_leaves(tree):
    """Every ``mem_k`` / ``mem_v`` of a cache tree, in jax's order."""
    from repro_torch.checkpoint.ckpt import _paths_and_leaves
    keys, leaves, _ = _paths_and_leaves(tree)
    return [x for k, x in zip(keys, leaves)
            if k.rsplit("/", 1)[-1] in ("mem_k", "mem_v")]


def tamed(cfg):
    """Whether ``tame_scores`` changes ``cfg``'s parameters."""
    return bool(cfg.encoder_layers)


def tame_scores(cfg, params):
    """``whisper-base``'s parameters with every ``wq`` and ``wk`` divided by
    8 (other archs' as given), for the card-vs-CPU checks.  Its random init
    takes the fan-in of ``[d, heads, hd]`` from ``heads`` (8, as the
    reference does), so its attention scores have a std of ~64: near-one-hot
    softmaxes whose ties flip with a sum's last bit.  Untamed, the card lay
    up to 0.086 in a logit and 0.23 of a leaf's largest gradient from the
    CPU at depth 2 on rounding alone; with scores of std ~1 the fixed
    bounds (0.01, 2e-3) can tell a wrong computation from rounding."""
    if not tamed(cfg):
        return params
    from repro_torch.checkpoint.ckpt import _paths_and_leaves
    keys, leaves, rebuild = _paths_and_leaves(params)
    return rebuild([x / 8 if k.rsplit("/", 1)[-1] in ("wq", "wk") else x
                    for k, x in zip(keys, leaves)])


def lm_against_cpu(arch, seed):
    """``arch`` at full width and a depth of ``lm_check_layers``, the same
    parameters on the card and on the CPU, computed in float32 and in
    bfloat16; every call decodes the greedy token of the CPU's float32
    prefill.  Per call (a prefill, a decode step, a 4-token extension, and
    the cache-free forward over the prompt, whose logits at every prompt
    position give the token check positions enough) and dtype, with r the
    CPU's own |dtype - float32| of the same call (0 at float32); whisper's
    parameters tamed first (``tame_scores``):

      * the largest |card - CPU| logit at most max(LM_LOGIT_TOL, 2 r_max),
        the mean at most max(LM_MEAN_TOL, 2 r_mean): a near tie of the MoE
        router, or an ulp through random RG-LRU gates, moves a bfloat16
        logit further than the order of a sum does;
      * at bfloat16, the card's own |bfloat16 - float32| at most
        LM_ROUNDING_RATIO times the CPU's, largest and mean: a wrong
        bfloat16 computation on the card moves its logits off its float32
        ones by about a logit's size;
      * the greedy tokens equal wherever the CPU's top-2 margin exceeds
        twice the position's largest |card - CPU|; the check fails when no
        position of a dtype has such a margin.

    The card's calls run here; the CPU's in a thread, which goes on beside
    whatever the caller runs next on the card (phase lm: the arch's serve).
    Returns the function that waits for the CPU's calls and makes the
    checks."""
    import threading
    from repro_torch.models import Model
    from repro_torch.models.common import lm_logits
    layers = lm_check_layers(arch)
    base = lm_config(arch, layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    params = {"cuda": tame_scores(base, Model(base).init(gen))}
    params["cpu"] = model_params_cpu(params["cuda"])
    prompt = torch.as_tensor(lm_prompts(seed + 11, base.vocab_size)[0])
    extra = lm_extra(base, seed + 11)
    npre = lm_prefix_len(base)
    max_len = npre + LM_PROMPT + LM_NEW + 8
    names = ("prefill", "decode_step", f"extend_step[{LM_DRAFT}]",
             f"forward[{LM_PROMPT}]")
    logits = {}
    fed, fed_ready, cpu_error, walls = {}, threading.Event(), [], {}

    def run(model, p, dev):
        """The four calls' logits (float32, on the CPU)."""
        batch = {"tokens": prompt.to(dev), **on(extra, dev)}
        first, caches = model.prefill(p, batch, max_len)
        if not fed:   # the CPU's float32 prefill decides what is fed
            cur = first.argmax(dim=-1).to(torch.int32)[:, None]
            fed.update(cur=cur, feed=torch.cat([cur, prompt[:, :LM_DRAFT - 1]],
                                               dim=1),
                       pos=torch.full((LM_BATCH,), npre + LM_PROMPT,
                                      dtype=torch.int32))
            fed_ready.set()
        pos = fed["pos"].to(dev)
        step, _ = model.decode_step(p, caches, fed["cur"].to(dev), pos)
        ext, _ = model.extend_step(p, caches, fed["feed"].to(dev), pos)
        x, positions, _ = model._embed_inputs(p, batch)
        x, _, _ = model._body(p, x, positions, memory=model._memory(p, batch))
        whole = lm_logits(p["emb"], x[:, npre:], model.cfg)
        return [x.float().cpu() for x in (first, step, ext, whole)]

    def cpu_side():
        try:
            for dtype in LM_LOGIT_TOL:   # float32 first: it decides the feed
                t0 = time.perf_counter()
                logits[dtype, "cpu"] = run(
                    Model(dataclasses.replace(base, dtype=dtype)),
                    params["cpu"], "cpu")
                walls[dtype, "cpu"] = time.perf_counter() - t0
        except BaseException as exc:   # raised again by the checks
            cpu_error.append(exc)
        finally:
            fed_ready.set()

    thread = threading.Thread(target=cpu_side, name=f"lm cpu {arch}",
                              daemon=True)
    thread.start()
    fed_ready.wait()
    if not cpu_error:
        for dtype in LM_LOGIT_TOL:
            t0 = time.perf_counter()
            logits[dtype, "cuda"] = run(
                Model(dataclasses.replace(base, dtype=dtype)),
                params["cuda"], "cuda")
            walls[dtype, "cuda"] = time.perf_counter() - t0
    del params["cuda"]
    torch.cuda.empty_cache()
    return lambda: lm_cpu_checks(arch, base, layers, names, thread, cpu_error,
                                 logits, walls)


def lm_cpu_checks(arch, base, layers, names, thread, cpu_error, logits,
                  walls):
    """``lm_against_cpu``'s checks, once its CPU thread has ended."""
    thread.join()
    if cpu_error:
        raise cpu_error[0]

    def gaps(a, b):
        return [((x - y).abs().max().item(), (x - y).abs().mean().item())
                for x, y in zip(a, b)]

    for dtype in LM_LOGIT_TOL:   # float32 first
        wall = walls[dtype, "cpu"] + walls[dtype, "cuda"]
        diffs = gaps(logits[dtype, "cuda"], logits[dtype, "cpu"])
        rounding = gaps(logits[dtype, "cpu"], logits["float32", "cpu"])
        card_rounding = gaps(logits[dtype, "cuda"], logits["float32", "cuda"])
        tols = [(max(LM_LOGIT_TOL[dtype], 2 * r), max(LM_MEAN_TOL[dtype],
                                                      2 * m))
                for r, m in rounding]
        biggest = max(float(x.abs().max()) for x in logits[dtype, "cpu"])
        say(f"[lm] {arch} at full width, {layers} layers, {dtype} compute, "
            f"the same parameters on the card and the CPU: |card - CPU| "
            f"logit largest/mean (bounds; |CPU {dtype} - CPU float32|, "
            f"|card {dtype} - card float32|) "
            + ", ".join(f"{n} {d:.6f}/{dm:.6f} ({t:.4f}/{tm:.4f}; "
                        f"{r:.4f}/{rm:.4f}, {c:.4f}/{cm:.4f})"
                        for n, (d, dm), (t, tm), (r, rm), (c, cm)
                        in zip(names, diffs, tols, rounding, card_rounding))
            + f"; largest |logit| {biggest:.3f}"
            + ("; wq and wk / 8" if tamed(base) else "")
            + f"; {wall:.1f} s (CPU {walls[dtype, 'cpu']:.1f} s in a thread "
            f"beside the arch's serve, card {walls[dtype, 'cuda']:.1f} s)")
        compared = total = 0
        for name, want, got, (d, dm), (t, tm), (r, rm), (c, cm) in zip(
                names, logits[dtype, "cpu"], logits[dtype, "cuda"], diffs,
                tols, rounding, card_rounding):
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"lm {arch}: card {name} logits not "
                                     f"finite")
            if d > t or dm > tm:
                raise AssertionError(
                    f"lm {arch}: {dtype} card {name} logits differ from the "
                    f"CPU's by {d} (mean {dm}) > {t} (mean {tm})")
            if dtype != "float32" and (c > LM_ROUNDING_RATIO * r
                                       or cm > LM_ROUNDING_RATIO * rm):
                raise AssertionError(
                    f"lm {arch}: the card's {dtype} {name} logits lie {c} "
                    f"(mean {cm}) from its float32 ones, more than "
                    f"{LM_ROUNDING_RATIO} x the CPU's {r} (mean {rm})")
            top2 = want.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > \
                2 * (got - want).abs().amax(dim=-1)
            same = got.argmax(dim=-1) == want.argmax(dim=-1)
            if not bool(same[clear].all()):
                raise AssertionError(
                    f"lm {arch}: {dtype} card {name} greedy tokens differ "
                    f"from the CPU's where the top-2 margin exceeds twice "
                    f"the position's largest |card - CPU|")
            compared += int(clear.sum())
            total += clear.numel()
        say(f"[lm] {arch} {dtype}: greedy tokens equal at the {compared} of "
            f"{total} positions whose top-2 margin exceeds twice the "
            f"position's largest |card - CPU|")
        if compared == 0:
            raise AssertionError(f"lm {arch}: {dtype} greedy tokens compared "
                                 f"at no position")


def start_lm_launcher():
    """Start ``python -m repro_torch.launch.serve --arch LM_LAUNCHER_ARCH``
    as a user runs it (2 requests, the launcher's other defaults), on the
    card, in a process of its own; returns the function that waits for it
    and checks it: exit 0 and its three lines.  Started beside phase
    kernels (correctness checks, nothing timed), it ends within it."""
    import re
    import tempfile
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         LM_LAUNCHER_ARCH, "--requests", "2"],
        env=dict(os.environ, PYTHONPATH=str(repo / "src")),
        cwd=repo, text=True, stdout=out, stderr=err)
    atexit.register(proc.kill)   # a failure before its check stops it too

    def finish():
        try:
            code = proc.wait(timeout=600)
        finally:
            proc.kill()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        for line in stdout.splitlines():
            say(f"[lm] launcher --arch {LM_LAUNCHER_ARCH}: {line}")
        say(f"[lm] launcher --arch {LM_LAUNCHER_ARCH}: exit {code} in "
            f"{time.perf_counter() - t0:.1f} s after its start (beside phase "
            f"kernels)")
        if code != 0 or not re.search(
                r"2 requests, 128 tokens in .*\(plain greedy would use 62\)"
                r".*maintenance: decay_steps=", stdout, re.S):
            raise AssertionError(f"the LM launcher failed ({code}): "
                                 f"{stdout[-2000:]} {stderr[-3000:]}")
    return finish


def lm_arch(arch, seed, card, profile, warm):
    """One arch's serving path at full width: random float32 parameters
    from a seeded generator on the card, the launcher's sizes; plain
    greedy, then speculation (the path's launch window) on the same
    prompts, tokens equal; latencies; the drafter's chain equal to a plain
    replay of the histories it learned.  Returns (launches, engine,
    histories, ctx, draft) for the kernel entries."""
    from repro_torch.core import speculative as spec
    from repro_torch.models import Model
    cfg = lm_config(arch)
    model = Model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 10)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    weight_bytes = param_bytes(params)
    say(f"[lm] {cfg}")
    say(f"[lm] {arch} at full width: {cfg.param_count()} parameters, "
        f"{weight_bytes / 1e9:.2f} GB of float32 made on the card from a "
        f"seeded generator in {time.perf_counter() - t0:.1f} s (device "
        f"memory allocated before: {before / 2**30:.2f} GiB); {LM_REQUESTS} "
        f"requests of {LM_BATCH} x {LM_PROMPT} prompt tokens, {LM_NEW} new "
        f"tokens each ({card})")
    prompts = lm_prompts(seed, cfg.vocab_size)
    if warm:   # cuBLAS and the drafter's kernels warm
        lm_serve(model, params, LM_DRAFT, prompts[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain, p_engine, _, _, p_wall = lm_serve(model, params, 0, prompts)
    with launch_window(f"lm {arch}", LM_KERNELS) as launches:
        toks, engine, histories, learn_ms, wall = lm_serve(
            model, params, LM_DRAFT, prompts)
    peak = torch.cuda.max_memory_allocated()
    if toks.shape != (LM_REQUESTS, LM_BATCH, LM_NEW) or \
            not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"lm {arch}: tokens of shape {toks.shape} out "
                             f"of range")
    if not np.array_equal(toks, plain):
        bad = np.argwhere(toks != plain)[0].tolist()
        raise AssertionError(f"lm {arch}: speculative tokens differ from "
                             f"plain greedy's, first at {bad}")
    st, pst = engine.stats, p_engine.stats
    if st["rounds"] <= 0 or st["accepted"] <= 0:
        raise AssertionError(f"lm {arch}: no draft was verified and "
                             f"accepted: {st}")
    n_tok = toks.size
    say(f"[lm] {arch}: speculative (draft_len {LM_DRAFT}) tokens == plain "
        f"greedy tokens, all {n_tok}; model calls {st['model_calls']} "
        f"against plain greedy's {pst['model_calls']}; {st['rounds']} verify "
        f"rounds, {st['drafted']} drafted, {st['accepted']} accepted: "
        f"acceptance {engine.acceptance_rate:.4f}; {st['draft_calls']} draft "
        f"calls ({card})")
    say(f"[lm] {arch} tokens/s, host clock over the {LM_REQUESTS} requests "
        f"(prefill, decode, learn): speculative {n_tok / wall:.1f} "
        f"({wall:.3f} s), plain greedy {n_tok / p_wall:.1f} ({p_wall:.3f} s) "
        f"({card})")
    model_ms = lm_model_ms(model, params, prompts[0])
    say(f"[lm] {arch} ms per call, latency on an idle device (events, "
        f"medians of 5): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in model_ms.items())
        + f"; reading the float32 weights once takes "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; a {LM_DRAFT}-token "
        f"extension == {LM_DRAFT} decode steps, logits and caches bit for "
        f"bit ({card})")
    lm_roofline(model, params, prompts[0], model_ms["decode_step"], card)
    if profile:
        cur = torch.as_tensor(toks[0, :, :1], device="cuda")
        _, caches = model.prefill(params, {"tokens": torch.as_tensor(
            prompts[0], device="cuda")}, LM_PROMPT + LM_NEW + 8)
        pos = torch.full((LM_BATCH,), LM_PROMPT, dtype=torch.int32,
                         device="cuda")
        profile_window(f"lm decode_step ({arch}, batch {LM_BATCH})",
                       lambda: model.decode_step(params, caches, cur, pos),
                       rounds=3)
        del caches
    say(f"[lm] {arch} peak device memory over both serves "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) ({card})")

    # the drafter: its published chain == the histories replayed through
    # the plain versions on the card, and a draft == the plain version's
    ngram = engine.cfg.ngram
    plain_ngram = dataclasses.replace(ngram, mc=dataclasses.replace(
        ngram.mc, impl="ref"))
    replay = spec.init(plain_ngram, device="cuda")
    for h in histories:
        spec.maintain_(spec.observe_(replay, h, cfg=plain_ngram),
                       cfg=plain_ngram)
    state = engine.drafter_store.acquire()
    engine.drafter_store.release(state)
    state = state.state
    equal_states(f"lm {arch}: the engine's drafter vs the plain replay of "
                 f"its histories", state.chain, replay.chain)
    # windows the drafter met: inside each learned continuation
    ctx = torch.as_tensor(np.concatenate([
        h[:, end - ngram.order:end] for h in histories
        for end in range(LM_PROMPT, LM_PROMPT + LM_NEW, 8)]), device="cuda")
    draft = spec.draft(state, ctx, cfg=ngram, k=LM_DRAFT)
    compare(f"lm {arch}: draft vs its plain version", draft,
            spec.draft(state, ctx, cfg=plain_ngram, k=LM_DRAFT))
    draft_ms = call_ms(lambda: spec.draft(state, ctx, cfg=ngram, k=LM_DRAFT))
    say(f"[lm] {arch}: the drafter after {len(histories)} learner steps: its "
        f"18 leaves == a plain replay's (impl=ref, on the card); a draft of "
        f"{ctx.shape[0]} windows == its plain version's "
        f"({int(draft[1][:, 0].sum())} first steps ok); _learn ms "
        + ", ".join(f"{x:.2f}" for x in learn_ms)
        + f" (host clock); draft k={LM_DRAFT} {draft_ms[0]:.4f} ms device, "
        f"{draft_ms[1]:.4f} ms on an idle device ({card})")
    del params, p_engine, replay
    return launches, engine, histories, ctx, draft


def device_busy_ms(fn, rounds=3):
    """Device milliseconds per ``fn()`` by torch.profiler (the kernels'
    device time summed over ``rounds`` calls), or None when the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(getattr(ev, "self_device_time_total", 0)
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 / rounds if busy_us > 0 else None


def lm_roofline(model, params, prompt, latency_ms, card):
    """The decode step's roofline at this phase's batch and context
    (``launch/roofline.py``): the time of its memory floor (the weights
    read once in bfloat16 and the cache of ``LM_PROMPT + LM_NEW``
    positions) beside the step's measured device time and latency, and the
    floor's share of each."""
    from repro_torch.launch import cells, roofline
    cfg = model.cfg
    cell = cells.Cell(cfg.name, "lm_decode", "decode", LM_BATCH,
                      LM_PROMPT + LM_NEW)
    floor_ms = roofline.memory_floor_bytes(cfg, cell) / roofline.HBM_BW * 1e3
    _, caches = model.prefill(params, {"tokens": torch.as_tensor(
        prompt, device="cuda")}, LM_PROMPT + LM_NEW + 8)
    cur = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((LM_BATCH,), LM_PROMPT, dtype=torch.int32,
                     device="cuda")
    dev_ms = device_busy_ms(lambda: model.decode_step(params, caches, cur,
                                                      pos))
    del caches
    dev = ("not measured (no device record)" if dev_ms is None else
           f"{dev_ms:.3f} ms (floor share {floor_ms / dev_ms:.4f})")
    say(f"[lm] {cfg.name} roofline of a decode step (batch {LM_BATCH}, "
        f"context {cell.seq}): memory floor "
        f"{roofline.memory_floor_bytes(cfg, cell) / 1e9:.3f} GB = "
        f"{floor_ms:.3f} ms at {roofline.HBM_BW / 1e12:g} TB/s; device "
        f"{dev} by torch.profiler over 3 steps; latency {latency_ms:.3f} ms "
        f"(floor share {floor_ms / latency_ms:.4f}) ({card})")


def phase_lm(seed, card, profile=False, launcher=None):
    """The LM serving path at full width for each of LM_ARCHS: the
    launcher as a user runs it (``mamba2-130m``); each arch served
    plain and speculative (``lm_arch``), its model against the CPU at a
    small depth; the drafter's kernels at the path's shapes (the first
    arch's drafter and histories), tagged ``[lm]``, their launches the sum
    over the archs' launch windows, each arch's beside it.  Each arch's
    card-vs-CPU forwards (``lm_against_cpu``) come first: the CPU's run in a
    thread beside that arch's serve on the card, on the host's cores but
    two, and their checks follow the serve.  ``launcher``: the launcher's
    check, started earlier (``start_lm_launcher``)."""
    t_phase = time.perf_counter()
    (launcher or start_lm_launcher())()
    took("lm launcher", t_phase)
    counts, entries = {}, []
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 2))   # two left for the card's host

    def checks(pending):
        t0 = time.perf_counter()
        pending()
        took("lm the card-vs-CPU checks, after the CPU's thread", t0)

    for i, arch in enumerate(LM_ARCHS):
        t0 = time.perf_counter()
        pending = lm_against_cpu(arch, seed + 100 * i)
        launches, engine, histories, ctx, draft = lm_arch(
            arch, seed + 100 * i, card, profile, warm=i == 0)
        counts[arch] = dict(launches)
        checks(pending)   # before the kernel entries' timings
        if i == 0:
            entries = lm_kernel_entries(engine, histories, ctx, draft,
                                        launches, seed,
                                        lm_config(arch).vocab_size)
        # an Engine's metrics provider closes over it: a cycle, so the
        # parameters it holds go at a collection, not at the del
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        took(f"lm {arch}", t0)
    for i, arch in enumerate(LM_MODEL_ARCHS):
        t0 = time.perf_counter()
        pending = lm_against_cpu(arch, seed + 100 * (len(LM_ARCHS) + i))
        lm_model_arch(arch, seed + 100 * (len(LM_ARCHS) + i), card)
        gc.collect()
        torch.cuda.empty_cache()
        checks(pending)
        took(f"lm {arch}", t0)
    torch.set_num_threads(threads)
    say(f"[lm] kernel launches by arch: "
        + "; ".join(f"{a} " + ", ".join(f"{k} {c[k]}" for k in LM_KERNELS)
                    for a, c in counts.items()))
    for entry in entries:    # the sum over the archs, each arch's beside it
        base = entry["name"].split("[")[0]
        entry["launches"] = sum(c[base] for c in counts.values())
        entry["launches_by_arch"] = {a: c[base] for a, c in counts.items()}
    return entries


def lm_model_arch(arch, seed, card):
    """An encoder or patch-prefix arch at full width through ``Model``:
    random float32 parameters from a seeded generator on the card, the stub
    frontend's inputs (``lm_extra``), 2 x 64 prompt tokens, a prefill and
    32 greedy decode steps (tokens in range, logits finite), then
    ``lm_model_ms`` (an extension == its decodes, the memory untouched;
    latencies); device memory before the init and the peak."""
    from repro_torch.models import Model
    from repro_torch.serve import sampling
    cfg = lm_config(arch)
    model = Model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 10)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    weight_bytes = param_bytes(params)
    extra = on(lm_extra(cfg, seed), "cuda")
    npre = lm_prefix_len(cfg)
    shapes = ", ".join(f"{k} {list(v.shape)}" for k, v in extra.items())
    say(f"[lm] {cfg}")
    say(f"[lm] {arch} at full width through Model: {cfg.param_count()} "
        f"parameters, {weight_bytes / 1e9:.2f} GB of float32 made on the card "
        f"from a seeded generator in {time.perf_counter() - t0:.1f} s (device "
        f"memory allocated before: {before / 2**30:.2f} GiB); {shapes}, "
        f"{LM_BATCH} x {LM_PROMPT} prompt tokens, {LM_NEW} greedy decodes "
        f"({card})")
    prompt = lm_prompts(seed, cfg.vocab_size)[0]
    batch = {"tokens": torch.as_tensor(prompt, device="cuda"), **extra}
    max_len = npre + LM_PROMPT + LM_NEW + 8
    model.prefill(params, batch, max_len)     # cuBLAS warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, max_len)
    toks = []
    for j in range(LM_NEW):
        cur = sampling.greedy(logits)
        toks.append(cur)
        logits, caches = model.decode_step(
            params, caches, cur[:, None].to(torch.int32),
            torch.full((LM_BATCH,), npre + LM_PROMPT + j, dtype=torch.int32,
                       device="cuda"))
    toks = torch.stack(toks, dim=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if toks.shape != (LM_BATCH, LM_NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"lm {arch}: greedy tokens {tuple(toks.shape)} "
                             f"out of range or logits not finite")
    say(f"[lm] {arch}: {LM_BATCH} x {LM_NEW} greedy tokens after a "
        f"{npre + LM_PROMPT}-position prefill in {wall:.3f} s, host clock: "
        f"{toks.numel() / wall:.1f} tokens/s ({card})")
    model_ms = lm_model_ms(model, params, prompt, extra)
    peak = torch.cuda.max_memory_allocated()
    say(f"[lm] {arch} ms per call, latency on an idle device (events, "
        f"medians of 5): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in model_ms.items())
        + f"; a {LM_DRAFT}-token extension == {LM_DRAFT} decode steps, "
        f"logits and caches bit for bit"
        + (", mem_k/mem_v as the prefill wrote them" if cfg.encoder_layers
           else "") + f"; peak device memory {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB) ({card})")
    del params, caches, logits


def lm_kernel_entries(engine, histories, ctx, draft, launches, seed, vocab):
    """The drafter's kernels at the shapes the path gave them: one more
    history (the last prompt with a new continuation, so the new-edge pass
    has new edges and new rows) through the chain's kernels, the draft
    windows through the walk, the learner's flags through the catch-up."""
    from repro_torch import core
    from repro_torch.core import speculative as spec
    from repro_torch.kernels import ops, walk
    ngram = engine.cfg.ngram
    state = engine.drafter_store.acquire()
    engine.drafter_store.release(state)
    state = state.state
    fresh = histories[-1].copy()
    fresh[:, LM_PROMPT:] = np.random.default_rng(seed + 12).integers(
        0, vocab, fresh[:, LM_PROMPT:].shape)
    hist = torch.as_tensor(fresh, device="cuda")
    src = spec.context_ids(hist, ngram.order)[:, :-1].reshape(-1)
    q = spec.context_ids(ctx, ngram.order)[:, -1].contiguous()
    entries = path_shape_kernels(state.chain, ngram.mc, src,
                                 hist[:, 1:].reshape(-1), q, launches,
                                 path="lm", reads=(), unfused=False)
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    learner_catch_up_entry(entries, launches, "copy_dirty_rows[lm]",
                           engine._learner)
    chain = state.chain
    window = ctx[:, -ngram.order:].contiguous()
    walk_args = (window, chain.src_table.keys, chain.src_table.vals,
                 chain.slabs.cnt, chain.slabs.dst, chain.slabs.order[:, 0])
    probed, found_steps, steps, trips, trips_max = walk_work(
        window, *draft, chain.src_table.keys, ngram.mc.max_probes, walk.LANES)
    kernel_entry(
        entries, launches, flush, f"draft_walk[lm, k={LM_DRAFT}]",
        "draft_walk", "walk.cu", "src/repro/kernels/walk.py:123",
        lambda impl: ops.draft_walk(*walk_args, k=LM_DRAFT,
                                    max_probes=ngram.mc.max_probes, impl=impl),
        bytes_moved=4 * (window.numel() + probed + 4 * found_steps)
        + window.shape[0] * LM_DRAFT * 5,
        operations=steps * (14 * ngram.order + 10) + 3 * probed,
        extra=dict(windows=window.shape[0], trips_per_step=trips,
                   trips_max=trips_max))
    return entries


# ---------------------------------------------------------------------------
# phase train: the training path (launcher, train step, compression) on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "mamba2-130m"     # the reference launcher's default arch
TRAIN_STEPS, TRAIN_RESTART_AT = 12, 6   # a cut of depth: 20, 10 before
TRAIN_GRAD_TOL = 2e-3          # |card - CPU| of a gradient, per leaf, as a
                               # share of its largest |gradient| (the CPU
                               # tests' bound against jax.grad)
TRAIN_LOSS_TOL = 1e-5          # |card - CPU| of the loss, relative (theirs)
WHISPER_TRAIN = dict(batch=4, tokens=128, microbatches=2, steps=4)
#: sequences of the card-vs-CPU gradients by arch: the launcher's batch for
#: the arch it trains, whisper's two (beside 1,500 frames each)
TRAIN_GRAD_BATCH = {TRAIN_ARCH: 8, "whisper-base": 2}
TRAIN_GRAD_TOKENS = 128        # tokens a sequence (the launcher's --seq)


def train_launcher(runs, log_every=10):
    """``python -m repro_torch.launch.train --arch mamba2-130m`` with the
    reference launcher's defaults (``--batch 8 --seq 128``) as a user runs
    it, once per ``(label, steps, ckpt_dir)`` of ``runs``, all at the same
    time, a loss printed every ``log_every`` steps: their lines, the first
    and last losses each printed, and the median seconds a step between two
    printed steps, on the host clock at each line's arrival (``None`` with
    fewer than two printed steps).  With ``log_every=1`` that is the median
    step after the process's first: a step's time without the start-up."""
    import threading
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--steps", str(steps), "--ckpt-dir", ckpt_dir,
         "--log-every", str(log_every)],
        env=dict(os.environ, PYTHONPATH=str(repo / "src")), cwd=repo,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for _, steps, ckpt_dir in runs]

    def read(stream, into, timed):
        for line in stream:
            into.append((time.perf_counter(), line) if timed else line)

    outs, errs = [[] for _ in procs], [[] for _ in procs]
    readers = [threading.Thread(target=read, args=args, daemon=True)
               for proc, out, err in zip(procs, outs, errs)
               for args in ((proc.stdout, out, True),
                            (proc.stderr, err, False))]
    for r in readers:
        r.start()
    results = []
    for (label, _, _), proc, out, err in zip(runs, procs, outs, errs):
        try:
            proc.wait(timeout=600)
        finally:
            proc.kill()
        for r in readers:
            r.join(timeout=10)
        for _, line in out:
            say(f"[train] launcher {label}: {line.rstrip()}")
        say(f"[train] launcher {label}: exit {proc.returncode}, "
            f"{time.perf_counter() - t0:.1f} s after the start")
        text = "".join(line for _, line in out)
        m = re.search(r"first loss (\S+) -> last loss (\S+)", text)
        if proc.returncode != 0 or m is None:
            raise AssertionError(f"the train launcher failed "
                                 f"({proc.returncode}): {text[-2000:]} "
                                 f"{''.join(err)[-3000:]}")
        at = [t for t, line in out if re.match(r"step\s+\d+ loss", line)]
        gaps = [(b - a) / log_every for a, b in zip(at, at[1:])]
        results.append((float(m.group(1)), float(m.group(2)),
                        statistics.median(gaps) if gaps else None))
    return results


def train_restart(card):
    """The launcher at full width: TRAIN_STEPS steps in one run and, beside
    it, a run to TRAIN_RESTART_AT that checkpoints there; then a second
    process that resumes that (alone: its s/step is the launcher's own);
    the two final
    checkpoints equal leaf for leaf, bit for bit."""
    import shutil
    root = persist_dir(3 * 3 * 4 * 130_000_000, "train checkpoints")
    try:
        whole, cut = os.path.join(root, "whole"), os.path.join(root, "cut")
        (first, last, _), _ = train_launcher([
            (f"{TRAIN_STEPS} steps", TRAIN_STEPS, whole),
            (f"to step {TRAIN_RESTART_AT}", TRAIN_RESTART_AT, cut)])
        if not (np.isfinite(first) and np.isfinite(last)):
            raise AssertionError(f"train: losses {first} -> {last}")
        (_, _, s_step), = train_launcher(
            [(f"resumed to step {TRAIN_STEPS}", TRAIN_STEPS, cut)],
            log_every=1)
        train_mfu(s_step, card)
        step = f"step_{TRAIN_STEPS:08d}"
        a = np.load(os.path.join(whole, step, "arrays.npz"))
        b = np.load(os.path.join(cut, step, "arrays.npz"))
        keys = [json.load(open(os.path.join(d, step, "manifest.json")))["keys"]
                for d in (whole, cut)]
        if keys[0] != keys[1] or sorted(a.files) != sorted(b.files):
            raise AssertionError("train: the two checkpoints hold other leaves")
        differ = [keys[0][int(f[1:])] for f in a.files
                  if not np.array_equal(a[f], b[f])]
        if differ:
            raise AssertionError(f"train: stopped at step {TRAIN_RESTART_AT} "
                                 f"and resumed, {len(differ)} leaves differ "
                                 f"from the uninterrupted run's: {differ[:8]}")
        say(f"[train] {TRAIN_ARCH}: stopped at step {TRAIN_RESTART_AT}, "
            f"resumed in a second process to step {TRAIN_STEPS}: all "
            f"{len(a.files)} leaves (params, AdamW's mu, nu and step) == the "
            f"uninterrupted run's, bit for bit; loss {first:.4f} -> "
            f"{last:.4f} ({card})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_mfu(s_step, card):
    """The launcher's step against the card's peak: ``model_flops`` of a
    step (6·N·D at the launcher's batch 8 x 128, ``launch/roofline.py``)
    over 989 TFLOP/s, and that time's share of the measured s/step (the
    resumed run's, alone on the card: the median of its steps after its
    first, each timed by its printed line's arrival): the model FLOPs
    utilisation."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cells, roofline
    cfg = get_config(TRAIN_ARCH)
    cell = cells.Cell(TRAIN_ARCH, "launcher", "train", 8, TRAIN_GRAD_TOKENS)
    flops = roofline.model_flops(cfg, cell)
    ideal_s = flops / roofline.PEAK_FLOPS_BF16
    say(f"[train] {TRAIN_ARCH} launcher mfu: model_flops {flops:.4e} a step "
        f"(batch 8 x {TRAIN_GRAD_TOKENS}) = {ideal_s * 1e3:.4f} ms at "
        f"{roofline.PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s; measured "
        + (f"{s_step:.4f} s/step (median of the resumed run's steps after "
           f"its first): mfu {ideal_s / s_step:.6f}"
           if s_step else "no s/step printed: mfu not measured")
        + f" ({card})")


def train_whisper(seed, card):
    """``whisper-base`` at full width through ``make_train_step``: frames
    [4, 1500, 512], 128 decoder tokens, ``microbatches=2``,
    ``compress_grads=True``, a few steps (losses finite, s/step); the
    gradients of a microbatch twice on the card, equal (the train path is
    deterministic); one int8 compression of them on the card == the same
    function on the CPU fed the same gradients and residual: codes, scales,
    compressed gradients and residual, bit for bit."""
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import Model
    from repro_torch.checkpoint.ckpt import _paths_and_leaves, tree_map
    from repro_torch.train import compression
    from repro_torch.train.train_step import (TrainConfig, grads_of,
                                              init_state, make_train_step)
    w = WHISPER_TRAIN
    cfg = lm_config("whisper-base")
    model = Model(cfg)
    tcfg = TrainConfig(microbatches=w["microbatches"], compress_grads=True,
                       total_steps=w["steps"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 20)
    state = init_state(model, gen, tcfg)
    step = make_train_step(model, tcfg)
    stream = token_stream(cfg.vocab_size, w["batch"], w["tokens"], seed=seed)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(w["steps"]):
        batch = {**next(stream), **lm_extra(cfg, seed + i, batch=w["batch"])}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or int(state.opt.step) != w["steps"]:
        raise AssertionError(f"train whisper-base: losses {losses}")
    say(f"[train] whisper-base at full width through make_train_step: frames "
        f"[{w['batch']}, {LM_FRAMES}, {cfg.d_model}], {w['tokens']} decoder "
        f"tokens, microbatches {w['microbatches']}, int8 compression with "
        f"error feedback, remat {cfg.remat!r}: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; s/step "
        + ", ".join(f"{x:.3f}" for x in secs) + f" (the first builds cuBLAS "
        f"plans); ef_residual_sq {float(metrics['ef_residual_sq']):.6g}; "
        f"peak device memory {peak / 2**30:.2f} GiB ({card})")
    half = {k: torch.as_tensor(v)[:w["batch"] // w["microbatches"]]
            for k, v in batch.items()}
    grads, _, _ = grads_of(model, state.params, half)
    again, _, _ = grads_of(model, state.params, half)
    same = [torch.equal(a, b) for a, b in zip(_paths_and_leaves(grads)[1],
                                              _paths_and_leaves(again)[1])]
    if not all(same):
        raise AssertionError(f"train whisper-base: the same microbatch's "
                             f"gradients differ between two calls on the "
                             f"card in {same.count(False)} leaves")
    out = {"cuda": compression.compress(grads, state.ef)}
    cpu = tree_map(lambda t: t.cpu(), grads)
    cpu_ef = compression.EFState(tree_map(lambda t: t.cpu(),
                                          state.ef.residual))
    out["cpu"] = compression.compress(cpu, cpu_ef)
    blocks = 0
    for g, r, gc_, rc in zip(_paths_and_leaves(grads)[1],
                             _paths_and_leaves(state.ef.residual)[1],
                             _paths_and_leaves(cpu)[1],
                             _paths_and_leaves(cpu_ef.residual)[1]):
        q, sc = compression.quantize_int8(g + r)
        qc, scc = compression.quantize_int8(gc_ + rc)
        if not (torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), scc)):
            raise AssertionError("train whisper-base: int8 codes or scales "
                                 "differ between the card and the CPU")
        blocks += q.shape[0]
    for part in (0, 1):
        tree = out["cuda"][part] if part == 0 else out["cuda"][1].residual
        want = out["cpu"][part] if part == 0 else out["cpu"][1].residual
        for a, b in zip(_paths_and_leaves(tree)[1],
                        _paths_and_leaves(want)[1]):
            if not torch.equal(a.cpu(), b):
                raise AssertionError("train whisper-base: compressed "
                                     "gradients or residual differ between "
                                     "the card and the CPU")
    say(f"[train] whisper-base: a microbatch's gradients twice on the card, "
        f"equal; their int8 compression ({blocks} blocks of "
        f"{compression.BLOCK}, {len(same)} leaves) == the CPU's on the same "
        f"gradients and residual: codes, scales, compressed gradients and "
        f"residual, bit for bit ({card})")
    del state, grads, again, out


def train_grads_against_cpu(arch, seed, card, layers=2):
    """``arch`` at full width and a depth of 2 (the encoder's too), float32
    compute: ``loss_fn``'s gradients on the card and on the CPU from the
    same parameters (``tame_scores``'d) and batch (TRAIN_GRAD_BATCH[arch]
    sequences of 128 tokens; whisper's frames [2, 1500, 512]).  Per leaf,
    |card - CPU| / the leaf's largest |CPU gradient| at most
    TRAIN_GRAD_TOL, and the loss within TRAIN_LOSS_TOL relative."""
    from repro_torch.checkpoint.ckpt import _paths_and_leaves
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import Model
    from repro_torch.train.train_step import grads_of
    cfg = dataclasses.replace(lm_config(arch, layers), dtype="float32")
    model = Model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 21)
    params = tame_scores(cfg, model.init(gen))
    rows = TRAIN_GRAD_BATCH[arch]
    batch = {**next(token_stream(cfg.vocab_size, rows, TRAIN_GRAD_TOKENS,
                                 seed=seed + 1)),
             **lm_extra(cfg, seed + 21, batch=rows)}
    t0 = time.perf_counter()

    def grads(p, dev):
        g, loss, _ = grads_of(model, p, {k: torch.as_tensor(v).to(dev)
                                         for k, v in batch.items()})
        keys, leaves, _ = _paths_and_leaves(g)
        return keys, [x.double().cpu() for x in leaves], float(loss)

    keys, card_g, card_loss = grads(params, "cuda")
    _, cpu_g, cpu_loss = grads(model_params_cpu(params), "cpu")
    gap = [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
           for x, y in zip(card_g, cpu_g)]
    worst = max(range(len(keys)), key=gap.__getitem__)
    loss_gap = abs(card_loss - cpu_loss) / abs(cpu_loss)
    say(f"[train] {arch} at full width, {layers} layers"
        + (" (encoder and decoder each)" if cfg.encoder_layers else "")
        + f", float32, {rows} x {TRAIN_GRAD_TOKENS} tokens"
        + ("; wq and wk / 8" if tamed(cfg) else "")
        + f": loss_fn's gradients card vs CPU over {len(keys)} leaves, "
        f"|card - CPU| / the leaf's largest |gradient| at most "
        f"{gap[worst]:.3g} at {keys[worst]} (bound {TRAIN_GRAD_TOL}); loss "
        f"{cpu_loss:.6f}, |card - CPU| {loss_gap:.3g} of it (bound "
        f"{TRAIN_LOSS_TOL}); {time.perf_counter() - t0:.1f} s ({card})")
    if not all(bool(torch.isfinite(x).all()) for x in card_g):
        raise AssertionError(f"train {arch}: a card gradient is not finite")
    if gap[worst] > TRAIN_GRAD_TOL:
        raise AssertionError(f"train {arch}: card gradient {keys[worst]} "
                             f"differs from the CPU's by {gap[worst]} of its "
                             f"largest > {TRAIN_GRAD_TOL}")
    if not loss_gap <= TRAIN_LOSS_TOL:
        raise AssertionError(f"train {arch}: card loss {card_loss} differs "
                             f"from the CPU's {cpu_loss} by {loss_gap} of it")


def model_params_cpu(params):
    from repro_torch.checkpoint.ckpt import tree_map
    return tree_map(lambda a: a.cpu(), params)


def phase_train(seed, card):
    """The training path at full width: the launcher on ``mamba2-130m``
    (12 steps, and a stop at step 6 resumed in another process, equal to
    the uninterrupted run bit for bit), ``whisper-base`` through
    ``make_train_step`` with microbatches and compression (its int8 codes
    == the CPU's on the same gradients), and depth-2 gradients card vs
    CPU on both archs.  No hand-written kernel is on this path: the window
    fails if one launches."""
    with launch_window("train", ()) as launches:
        t0 = time.perf_counter()
        train_restart(card)
        took("train launcher", t0)
        t0 = time.perf_counter()
        train_whisper(seed, card)
        gc.collect()
        torch.cuda.empty_cache()
        took("train whisper-base", t0)
    if any(launches.values()):
        raise AssertionError(f"train: a hand-written kernel launched on the "
                             f"training path: {launches}")
    for arch in TRAIN_GRAD_BATCH:
        t0 = time.perf_counter()
        train_grads_against_cpu(arch, seed, card)
        torch.cuda.empty_cache()
        took(f"train {arch} gradients card vs CPU", t0)


def took(label, t0):
    """Wall seconds of a part of a phase, for the cuts of depth."""
    say(f"[time] {label}: {time.perf_counter() - t0:.1f} s")


def cache_child_bytecode():
    """The processes this script starts (the launchers, the soak's workers,
    the examples) compile torch's Python sources on every start where the
    environment forbids writing bytecode (about 10 s an ``import torch``):
    they write it once under the checkout's ``build/pycache`` instead and
    read it there after."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(
        Path(__file__).resolve().parent / "build" / "pycache")


def tensor_leaves(tree):
    """Every tensor of nested dicts, lists and (named) tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def param_bytes(tree):
    """Bytes of every tensor in a parameter tree."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm-batches", type=int, default=4400,
                    help="update batches of the main path's warm-up; the "
                         "drafter's warm-up observes a quarter as many, "
                         "phase persist's chain half, phase sharded 1/8")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="after the main, drafter and sharded phases, print "
                         "device time by kernel (torch.profiler) over a few "
                         "more rounds; in phase persist, over the reshard's "
                         "first routed updates")
    ap.add_argument("--topn-pace-ms", type=float, default=0.0,
                    help="in phase engine, the top-16 reader starts a read at "
                         "most every this many ms (default 0: back to back), "
                         "to hold the read rate while comparing the writer")
    args = ap.parse_args(argv)
    global TOPN_PACE_MS
    TOPN_PACE_MS = args.topn_pace_ms
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    cache_child_bytecode()
    t_start = time.perf_counter()
    seconds, last = {}, [t_start]

    def lap(name):   # wall seconds of the phase that just ended
        now = time.perf_counter()
        seconds[name] = round(now - last[0], 1)
        last[0] = now

    card, dryrun_done = phase_device()
    lap("device")
    # the launchers' processes run beside the kernels' checks
    launcher = start_lm_launcher() if "lm" in phases else None
    engine_launch = start_engine_launcher() if "engine" in phases else None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    kernels = []
    if "kernels" in phases:
        small_kernel_checks(gen)
    dryrun_done()   # the dry run's processes ran on the host meanwhile
    if "kernels" in phases:
        lap("kernels")
    if "main" in phases:
        state, cfg, traffic, launches, known = phase_main(
            args.seed, args.warm_batches, args.rounds)
        src, dst = traffic.batch(BATCH)
        kernels = path_shape_kernels(state, cfg, src, dst, traffic.srcs(QUERIES),
                                     launches)
        del src, dst
        if args.profile:
            from repro_torch import core

            def mixed_round():
                src, dst = traffic.batch(BATCH)
                q = traffic.srcs(QUERIES)
                core.update_batch_(state, src, dst, cfg=cfg)
                core.query_threshold(state, q, 0.9, cfg=cfg, max_items=16)
                core.query_topk(state, q, cfg=cfg, k=8)

            profile_window("update_ (new edges) + 2 queries", mixed_round)
            profile_window("update_batch_ on existing edges only",
                           lambda: core.update_batch_(state, *known[:2], None,
                                                      known[2], cfg=cfg))
        del state
        torch.cuda.empty_cache()
        lap("main")
    if "hash" in phases:
        state, cfg, traffic, launches = phase_hash(
            args.seed, args.warm_batches, args.rounds)
        src, dst = traffic.batch(BATCH)
        kernels += hash_path_kernels(state, cfg, src, dst, launches)
        del state, src, dst
        torch.cuda.empty_cache()
        lap("hash")
    if "drafter" in phases:
        kernels += phase_drafter(args.seed, args.warm_batches // 4,
                                 args.rounds, args.profile)
        torch.cuda.empty_cache()
        lap("drafter")
    if "lm" in phases:
        kernels += phase_lm(args.seed, card, args.profile, launcher)
        torch.cuda.empty_cache()
        lap("lm")
    if "train" in phases:
        phase_train(args.seed, card)
        lap("train")
    if "sharded" in phases:
        state, scfg, traffic, launches = phase_sharded(
            args.seed, sharded_warm(args), args.rounds)
        kernels += sharded_path_kernels(state, scfg, traffic, launches)
        if args.profile:
            from repro_torch.core import sharded as sh
            w = torch.ones(SHARDS * BATCH, dtype=torch.int32, device="cuda")

            def sharded_round():
                src, dst = traffic.batch(SHARDS * BATCH)
                sh.update_(state, src, dst, w, scfg=scfg)
                sh.query(state, traffic.srcs(SHARDS * QUERIES), 0.9, 16,
                         scfg=scfg)
                sh.maintain_(state, scfg=scfg, total_threshold=64)

            profile_window("sharded round (update_ + query + maintain_)",
                           sharded_round)
            profile_window("sharded topn", lambda: sh.topn(state, TOP_N,
                                                           scfg=scfg))
        lap("sharded")
        if "engine" in phases:
            kernels += phase_engine(state, scfg, args.seed,
                                    engine_launch)
            lap("engine")
        if "persist" in phases:
            box = [state]
            del state
            kernels += persist_reshard(box, scfg, args.profile)
            lap("persist (reshard)")
        else:
            del state
        torch.cuda.empty_cache()
    elif "persist" in phases or "engine" in phases:
        state, scfg = sharded_warm_state(args.seed, sharded_warm(args))
        if "engine" in phases:
            kernels += phase_engine(state, scfg, args.seed,
                                    engine_launch)
        box = [state]
        del state
        if "persist" in phases:
            kernels += persist_reshard(box, scfg, args.profile)
        del box
        torch.cuda.empty_cache()
        lap("engine, persist (reshard)")
    if "ranks" in phases:
        by_run = phase_ranks(args.seed, card)
        for entry in kernels:     # the sharded path's and the engine's
            base, _, tags = entry["name"].partition("[")
            if tags.startswith(("sharded", "engine")):
                entry["launches_ranks"] = {
                    run: ([c.get(base, 0) for c in counts]
                          if isinstance(counts, list) else counts.get(base, 0))
                    for run, counts in by_run.items()}
        lap("ranks")
    if "persist" in phases:
        phase_persist(args.seed, args.warm_batches // 2)
        torch.cuda.empty_cache()
        lap("persist (chain)")
    if "monitor" in phases:
        phase_monitor(args.seed)
        lap("monitor")
    if "soak" in phases:
        kernels += phase_soak(args.seed)
        lap("soak")
    examples_done = phase_examples() if "examples" in phases else None
    if "parity" in phases:
        kernels += phase_parity(args.seed, beside=examples_done)
        lap("examples, parity" if examples_done else "parity")
    elif examples_done:
        examples_done()
        lap("examples")
    torch.cuda.synchronize()
    say(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f} s; "
        f"seconds by phase {seconds}")
    say(card)
    if set(phases) != set(PHASES):
        say(json.dumps({"kernels": kernels}))
        say("chip_smoke: partial run (--phases): no result line")
        return 0
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
