#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as below
    python3 chip_smoke.py --phases device,kernels   # a subset, for debugging

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` from source, then

  1. device   — card name and power limit, torch/CUDA versions, build time;
  2. kernels  — every kernel against its plain PyTorch version ON the card at
                small odd shapes (ragged batches, padding rows, saturated
                tables, duplicates, unknown srcs, ``max_items > C``, threshold
                and top-k mode); outputs must be EQUAL (tolerance 0, integers
                and float32 alike);
  3. main     — the main path at full width: a chain of 2**20 source rows x 128
                slots, warmed by streaming ``update_batch`` calls of 65,536
                transitions, then rounds of update + threshold query + top-k
                query + maintenance, with launch counts read around the
                rounds and no device->host synchronisation allowed inside
                ``update_batch`` and the queries; then each kernel at the
                shapes and data that path gave it, against its plain version
                (equal) and timed beside its bound;
  4. parity   — the whole path at a small configuration, once with the CUDA
                kernels and once with the plain versions, every state leaf and
                every query answer equal after every batch.

Any failing phase raises and the script exits non-zero; without a CUDA device
it exits non-zero at once.  The last line of standard output is
``{"ok": true, "device": {...}}``, the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12         # non-tensor-core 32-bit rate (data sheet, fp32)
PHASES = ("device", "kernels", "main", "parity")


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


def phase_device():
    from repro_torch.kernels import _build
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
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say("[device]   " + line.strip())
    return card


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

    for c in (1, 5, 32, 96, 128):
        n = 37
        dst, cnt, tot, order = random_slabs(gen, n, c)
        # oddeven: random permutations, ties, several pass counts
        small = torch.where(cnt > 0, cnt % 4, 0).to(torch.int32)
        perm = random_perm_rows(gen, n, c)
        for passes in (0, 1, 2, c // 2 + 1):
            both(f"oddeven C={c} passes={passes}", ops.oddeven_sort, small, perm,
                 passes=passes)
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

    # probe: tombstone chains, wrap-around, saturated windows, padding rows
    for n, h, max_probes, fill, delete_frac in (
            (4, 32, 32, 12, 0.0), (3, 16, 8, 14, 0.5), (2, 8, 16, 7, 0.4),
            (5, 64, 4, 40, 0.9), (1, 1, 3, 1, 0.0)):
        keys, vals = build_tables(gen, n, h, max_probes, fill, delete_frac)
        for batch in (0, 1, 203):
            rows = randint(gen, -1, n, (batch,))
            q = randint(gen, 0, 520, (batch,))
            both(f"dh_find N={n} H={h} P={max_probes} B={batch}", ops.dh_find,
                 rows, q, keys, vals, max_probes=max_probes)
            both(f"ht_find H={h} P={max_probes} B={batch}", ops.ht_find, q,
                 keys[0].contiguous(), vals[0].contiguous(),
                 max_probes=max_probes)

    # slow path: rows and slots running out, tiny table with a short window
    from repro_torch.core import mcprioq as mc
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
            st = mc._slow_path(st, src, dsts, w, active, cfg)
            st = st._replace(slabs=st.slabs._replace(
                order=random_perm_rows(gen, num_rows, c)))
    say(f"[kernels] {checked} small-shape comparisons, kernel == plain version "
        f"(torch.equal) in all")


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

NUM_NODES = 2 ** 20
OUT_DEGREE = 32
BATCH = 65_536
QUERIES = 4_096


class Traffic:
    """Zipf transition stream made on the device: uniform ``src`` over
    2**20 nodes, Zipf(1.5) rank over 32 successors, ``dst`` a fixed hash of
    ``(src, rank)``."""

    def __init__(self, seed):
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(seed)
        ranks = torch.arange(1, OUT_DEGREE + 1, device="cuda", dtype=torch.float64)
        self.probs = (ranks ** -1.5 / (ranks ** -1.5).sum()).float()

    def batch(self, size):
        from repro_torch.core.hashtable import hash_u32
        src = randint(self.gen, 0, NUM_NODES, (size,))
        rank = torch.multinomial(self.probs, size, replacement=True,
                                 generator=self.gen)
        dst = (hash_u32(src.long() * OUT_DEGREE + rank) & 0x7FFFFFFF).to(torch.int32)
        return src, dst

    def srcs(self, size):
        return randint(self.gen, 0, NUM_NODES + NUM_NODES // 16, (size,))


def kernel_modules():
    from repro_torch.kernels import cdf_gather, oddeven, probe, slab_update, slow_path
    return {"probe_find": probe, "slab_update": slab_update, "oddeven": oddeven,
            "cdf_query_fused": cdf_gather, "slow_path": slow_path}


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


def phase_main(seed, warm_seconds, rounds):
    from repro_torch import core
    cfg = core.MCConfig(num_rows=NUM_NODES, capacity=128, sort_passes=1,
                        decay_block_rows=1024, max_new_per_batch=8192,
                        impl="auto")
    traffic = Traffic(seed)
    torch.cuda.reset_peak_memory_stats()
    state = core.init(cfg)
    say(f"[main] {cfg}")
    say(f"[main] table {cfg.resolved_table_size()} slots; state "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")

    # warm-up: stream batches for a fixed budget
    t0 = time.perf_counter()
    batches = 0
    while True:
        for _ in range(10):
            src, dst = traffic.batch(BATCH)
            state = core.update_batch(state, src, dst, cfg=cfg)
        batches += 10
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= warm_seconds:
            break
    stats = core.counter_stats(state)
    say(f"[main] warm-up: {batches} batches of {BATCH} in "
        f"{time.perf_counter() - t0:.1f} s (budget {warm_seconds} s); "
        f"n_rows {stats['n_rows']} deferred_new {stats['deferred_new']}")

    # measured rounds: launch counts are read around exactly this block
    mods = kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    times = {}
    decay_threshold = 64
    for _ in range(rounds):
        src, dst = traffic.batch(BATCH)
        q = traffic.srcs(QUERIES)
        state = timed(times, "update_batch", no_sync, core.update_batch,
                      state, src, dst, cfg=cfg)
        answers = timed(times, "query_threshold", no_sync, core.query_threshold,
                        state, q, 0.9, cfg=cfg, max_items=16)
        top = timed(times, "query_topk", no_sync, core.query_topk, state, q,
                    cfg=cfg, k=8)
        state = timed(times, "maybe_decay", core.maybe_decay, state, cfg=cfg,
                      total_threshold=decay_threshold)
    state = timed(times, "decay", core.decay, state, cfg=cfg)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}

    med = {k: statistics.median(s.elapsed_time(e) for s, e in v)
           for k, v in times.items()}
    say(f"[main] {rounds} rounds; median ms per call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    say(f"[main] observe {BATCH / med['update_batch'] * 1e3:.0f} edges/s; "
        f"query_threshold {QUERIES / med['query_threshold'] * 1e3:.0f} queries/s; "
        f"query_topk {QUERIES / med['query_topk'] * 1e3:.0f} queries/s "
        f"(device time by CUDA events, no synchronisation inside the calls)")
    say(f"[main] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"[main] counters {core.counter_stats(state)}")
    say(f"[main] maintenance {core.maintenance_stats(state)}")
    say(f"[main] kernel launches in the rounds: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

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
        timed(steady, "update_batch", no_sync, core.update_batch, state, k_src,
              k_dst, None, k_mask, cfg=cfg)
    torch.cuda.synchronize()
    steady_ms = statistics.median(
        s.elapsed_time(e) for s, e in steady["update_batch"][2:])
    say(f"[main] update_batch on {int(k_mask.sum())} existing edges only (empty "
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
    say(f"[profile] {label}: {rounds} rounds in {wall_ms:.1f} ms wall (profiler "
        f"on); device busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f} % of "
        f"the window")
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    for ms, count, key in rows[:12]:
        say(f"[profile]   {ms:9.3f} ms  {100 * ms / busy_ms:5.1f} %  x{count:<5d} {key[:90]}")


# ---------------------------------------------------------------------------
# phase 3b: each kernel at the main path's shapes, against its plain version
# ---------------------------------------------------------------------------


def bound(bytes_moved, operations):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = operations / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def main_shape_kernels(state, cfg, traffic, launches):
    """Recreate the inputs ``update_batch``/``query_*``/``decay`` hand each
    kernel (same functions, this state, one more batch), hold the kernel
    against its plain version on them, and time both."""
    from repro_torch.core import mcprioq as mc
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MiB
    n, c = cfg.num_rows, cfg.capacity
    slabs, table = state.slabs, state.src_table
    h = table.keys.shape[0]
    entries = []

    def entry(name, module, source, replaces, run, bytes_moved, operations,
              plain_reps=3, library=None):
        got = run("cuda")
        torch.cuda.synchronize()
        want = run("ref")
        err = compare(name, got, want)
        del got, want
        ms = time_ms(lambda: run("cuda"), reps=10, warm=2, flush=flush)
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
            "library_ms": library_ms})
        say(f"[kernels] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; equal")

    # inputs as update_batch makes them
    src, dst = traffic.batch(BATCH)
    w = torch.ones_like(src)
    m = torch.ones_like(src, dtype=torch.bool)
    u_src, u_dst, u_w, u_act, u_pos = mc._aggregate_batch(src, dst, w, m)
    rows0, found_src0 = mc.lookup_rows(state, u_src, cfg)
    _, found_d0 = mc._find_slots(state, rows0, u_dst, cfg)
    fast = u_act & found_src0 & found_d0
    fast_rows = torch.where(fast, rows0, -1)
    p_src, p_dst, p_w, p_mask, _ = mc._take_new_prefix(
        u_src, u_dst, u_w, u_pos, u_act & ~fast, cfg.resolved_max_new(BATCH))

    # probe: B keys + rows in, 2 B out; the chain each query must read
    p = torch.arange(cfg.max_probes, device="cuda")
    win = table.keys[((mc.ht.hash_u32(u_src) & (h - 1)).unsqueeze(1) + p) & (h - 1)]
    stop = mc.ht.first_true((win == u_src.unsqueeze(1)) | (win == -1), dim=1)[0] \
        .clamp(max=cfg.max_probes - 1) + 1
    chain_reads = int(stop.sum()) + int(found_src0.sum())
    entry("probe_find", "probe_find", "probe.cu",
          "src/repro/kernels/probe.py:105",
          lambda impl: ops.ht_find(u_src, table.keys, table.vals,
                                   max_probes=cfg.max_probes, impl=impl),
          bytes_moved=4 * (4 * BATCH + chain_reads),
          operations=12 * BATCH + 3 * chain_reads)
    del win, stop

    # slab_update: cnt/tot copied (read + write), items in, scanned row prefixes
    hit_slot = mc.ht.first_true(slabs.dst[rows0.long()] == u_dst.unsqueeze(1),
                                dim=1)[0] + 1
    scanned = int(torch.where(fast, hit_slot, 0).sum())
    entry("slab_update", "slab_update", "slab_update.cu",
          "src/repro/kernels/slab_update.py:75",
          lambda impl: ops.slab_update(fast_rows, u_dst, u_w, slabs.dst,
                                       slabs.cnt, slabs.tot, impl=impl),
          bytes_moved=4 * (2 * n * c + 2 * n + 3 * BATCH + scanned + 2 * int(fast.sum())),
          operations=2 * scanned + 4 * BATCH)
    del hit_slot

    # oddeven at the update's shape: cnt + order in, order out
    entry("oddeven", "oddeven", "oddeven.cu",
          "src/repro/kernels/oddeven.py:67",
          lambda impl: ops.oddeven_sort(slabs.cnt, slabs.order,
                                        passes=cfg.sort_passes, impl=impl),
          bytes_moved=4 * 3 * n * c,
          operations=cfg.sort_passes * n * c * 3)

    # oddeven as decay's full sort: one block, C//2+1 passes; torch.sort beside it
    r = cfg.resolved_decay_rows()
    blk_cnt = (slabs.cnt[:r] >> 1).contiguous()
    blk_ord = slabs.order[:r].contiguous()
    blk_c_ord = torch.gather(blk_cnt, 1, blk_ord.long())
    entry("oddeven[decay_sort]", "oddeven", "oddeven.cu",
          "src/repro/kernels/oddeven.py:67",
          lambda impl: ops.oddeven_sort(blk_cnt, blk_ord, passes=c // 2 + 1,
                                        impl=impl),
          bytes_moved=4 * 3 * r * c,
          operations=(c // 2 + 1) * r * c * 3,
          library=lambda: torch.sort(-blk_c_ord, dim=1, stable=True))

    # fused query: threshold and top-k; per known src the positions it needs
    q = traffic.srcs(QUERIES)
    q_rows, q_found = mc.lookup_rows(state, q, cfg)
    for label, t, k in (("cdf_query_fused", 0.9, 16), ("cdf_query_fused[topk]", None, 8)):
        _, _, nn = ref.cdf_query_fused_ref(q_rows, q_found, slabs.cnt, slabs.dst,
                                           slabs.order, slabs.tot, t, k)
        known = int(q_found.sum())
        walked = known * c if t is None else int(nn.sum())
        emitted = int(nn.clamp(max=k).sum())
        entry(label, "cdf_query_fused", "cdf_gather.cu",
              "src/repro/kernels/cdf_gather.py:95",
              lambda impl, t=t, k=k: ops.cdf_query_fused(
                  q_rows, q_found, slabs.cnt, slabs.dst, slabs.order, slabs.tot,
                  t, max_items=k, chunks=cfg.query_chunks, impl=impl),
              bytes_moved=4 * (2 * QUERIES + known + 2 * walked + emitted
                               + QUERIES * (2 * k + 1)),
              operations=8 * walked + 4 * QUERIES * k)

    # slow path: tables copied (read + write), items in; one dependent chain
    counters = torch.stack([state.n_rows, state.dropped_rows,
                            state.dropped_probes, state.evictions])
    n_active = int(p_mask.sum())
    say(f"[kernels] slow_path input: {n_active} active of {p_mask.numel()} items")
    entry("slow_path", "slow_path", "slow_path.cu",
          "src/repro/core/mcprioq.py:311",
          lambda impl: ops.slow_path(table.keys, table.vals, slabs.dst,
                                     slabs.cnt, slabs.tot, slabs.order, counters,
                                     p_src, p_dst, p_w, p_mask,
                                     max_probes=cfg.max_probes, impl=impl),
          bytes_moved=4 * (2 * (2 * h + 2 * n * c + n + 4) + 4 * p_mask.numel()
                           + n_active * (2 + 2 * c + 4)),
          operations=n_active * (2 * cfg.max_probes + 4 * c),
          plain_reps=1)
    return entries


# ---------------------------------------------------------------------------
# phase 4: the whole path, kernels vs plain versions, on the card
# ---------------------------------------------------------------------------


def phase_parity(seed, batches=32):
    import dataclasses
    from repro_torch import convert, core
    cfg_k = core.MCConfig(num_rows=512, capacity=32, sort_passes=1,
                          max_new_per_batch=192, decay_block_rows=128,
                          impl="cuda")
    cfg_p = dataclasses.replace(cfg_k, impl="ref")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    sk, sp = core.init(cfg_k), core.init(cfg_p)
    nodes, degree, size = 700, 96, 512
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
        if i == batches // 2:
            sk, sp = core.decay(sk, cfg=cfg_k), core.decay(sp, cfg=cfg_p)
        torch.cuda.synchronize()
        lk, lp = convert.state_to_numpy(sk), convert.state_to_numpy(sp)
        for name in convert.LEAF_NAMES:
            if not (lk[name] == lp[name]).all():
                raise AssertionError(f"parity: batch {i}: leaf {name} differs "
                                     f"between impl='cuda' and impl='ref'")
        q = randint(gen, 0, nodes + 50, (300,))
        compare(f"parity query_threshold batch {i}",
                core.query_threshold(sk, q, 0.8, cfg=cfg_k, max_items=12),
                core.query_threshold(sp, q, 0.8, cfg=cfg_p, max_items=12))
        compare(f"parity query_topk batch {i}",
                core.query_topk(sk, q, cfg=cfg_k, k=5),
                core.query_topk(sp, q, cfg=cfg_p, k=5))
    stats = core.counter_stats(sk)
    say(f"[parity] {batches} batches at {cfg_k.num_rows}x{cfg_k.capacity}: all "
        f"{len(convert.LEAF_NAMES)} state leaves and all query answers equal "
        f"after every batch; counters {stats}")
    for need in ("deferred_new", "evictions", "dropped_rows", "decay_steps"):
        if stats[need] <= 0:
            raise AssertionError(f"parity stream never exercised {need}")
    inv = core.check_invariants(sk, cfg_k)
    if not all(v for k, v in inv.items() if k != "sorted_fraction"):
        raise AssertionError(f"parity: invariants violated: {inv}")


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm-seconds", type=float, default=60.0,
                    help="budget of the main path's warm-up stream")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="after the main phase, print device time by kernel "
                         "(torch.profiler) over a few more rounds")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    kernels = []
    if "kernels" in phases:
        small_kernel_checks(gen)
    if "main" in phases:
        state, cfg, traffic, launches, known = phase_main(
            args.seed, args.warm_seconds, args.rounds)
        kernels = main_shape_kernels(state, cfg, traffic, launches)
        if args.profile:
            from repro_torch import core

            def mixed_round():
                src, dst = traffic.batch(BATCH)
                q = traffic.srcs(QUERIES)
                new_state = core.update_batch(state, src, dst, cfg=cfg)
                core.query_threshold(new_state, q, 0.9, cfg=cfg, max_items=16)
                core.query_topk(new_state, q, cfg=cfg, k=8)

            profile_window("update (new edges) + 2 queries", mixed_round)
            profile_window("update_batch on existing edges only",
                           lambda: core.update_batch(state, *known[:2], None,
                                                     known[2], cfg=cfg))
        del state
        torch.cuda.empty_cache()
    if "parity" in phases:
        phase_parity(args.seed)
    torch.cuda.synchronize()
    say(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f} s")
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
