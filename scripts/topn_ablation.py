"""Where the time of the sharded top-n goes on an NVIDIA GPU, and what the
window kernel's two choices buy.

Builds copies of ``csrc/topn_windows.cu``, each with one choice changed —
the rows a warp takes a step (the kernel's ``mcq_tw_group``: 4 at k = 16)
and the resident blocks an SM the grid is sized for (two) — into libraries
of their own beside the package's (``scripts/kernel_ablation.py``'s
``build``), and times each copy's window lists in turns with the kernel as
built; then the package's whole read, the merge and the srcs' pass alone,
and the plain torch they replace (the windows' stable sort, the row -> src
scatter).

The inputs are seeded random slabs at phase sharded's shape of
``chip_smoke.py`` (4 shards x 2^20 rows x 128 slots, 60 % of the slots
live with counts 1-999, the order sorted by count; src tables of 4 x 2^20
lanes holding every row), top-16.  Every copy's lists are checked equal to
the plain mirror at its block count first.  Times are medians of 20 calls
by CUDA events, the L2 flushed before each call, over ``--turns`` turns.

    python3 scripts/topn_ablation.py [--turns 3] [--out FILE.json]

It needs a CUDA device and ``nvcc``, and exits non-zero without them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT_DIR = ROOT / "build" / "topn_ablation"
SHARDS, ROWS, CAP, TOP_N = 4, 2 ** 20, 128, 16


def _sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"ablation anchor not found in the source: {old!r}")
    return text.replace(old, new)


def window_variants(src):
    """name -> source of ``topn_windows.cu`` with one choice changed."""
    group = "static int mcq_tw_group(int cpad, int kpad, int k, int n) {\n"
    per_sm = "per_sm = per_sm < 1 ? 1 : per_sm > 2 ? 2 : per_sm;"
    out = {"topn_windows": src}
    for rows in (1, 2, 8):
        out[f"topn_windows: {rows} row{'s' * (rows > 1)} a step"] = _sub(
            src, group, group + f"  if (k > 0) return {rows};\n")
    out["topn_windows: four blocks an SM"] = _sub(
        src, per_sm, "per_sm = per_sm < 1 ? 1 : per_sm > 4 ? 4 : per_sm;")
    out["topn_windows: one block an SM"] = _sub(src, per_sm, "per_sm = 1;")
    return out


def time_ms(fn, flush, reps=20, warm=2):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slabs(seed):
    """cnt, order, tot, dst [S, N, C] / [S, N] and the src tables [S, T]."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (SHARDS, ROWS, CAP)

    def randint(lo, hi, size):
        return torch.randint(lo, hi, size, generator=gen, device="cuda",
                             dtype=torch.int32)

    live = torch.rand(shape, generator=gen, device="cuda") < 0.6
    cnt = torch.where(live, randint(1, 1000, shape), 0).to(torch.int32)
    del live
    order = torch.sort(-cnt, dim=2, stable=True).indices.to(torch.int32)
    tot = cnt.sum(dim=2).to(torch.int32)
    dst = randint(0, 10 ** 6, shape)
    table = 4 * ROWS
    lane = torch.randperm(table, generator=gen, device="cuda")[:ROWS]
    keys = torch.full((SHARDS, table), -1, dtype=torch.int32, device="cuda")
    vals = torch.full((SHARDS, table), -1, dtype=torch.int32, device="cuda")
    keys[:, lane] = (torch.arange(SHARDS * ROWS, dtype=torch.int32,
                                  device="cuda").view(SHARDS, ROWS) * 3 + 1)
    vals[:, lane] = torch.arange(ROWS, dtype=torch.int32, device="cuda")
    return cnt, order, tot, dst, keys, vals


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("topn_ablation: no CUDA device", file=sys.stderr)
        return 2
    import kernel_ablation
    from repro_torch.core import sharded as sh
    from repro_torch.kernels import ref, topn_merge as tm, topn_windows as tw
    libs = kernel_ablation.build(
        window_variants((CSRC / "topn_windows.cu").read_text()), {},
        out_dir=OUT_DIR)
    cnt, order, tot, dst, keys, vals = slabs(args.seed)
    read = (cnt, order, tot, dst, keys, vals)
    k = min(TOP_N, CAP)

    def lists_of(lib):
        """A copy's window lists at its own block count, checked against
        the mirror; returns the call to time and the block count."""
        blocks = lib.mcq_topn_windows_blocks(SHARDS, ROWS, CAP, k, TOP_N,
                                             ref.merge_lists_per_launch(TOP_N))
        lists = torch.empty((SHARDS * blocks, TOP_N), dtype=torch.int64,
                            device="cuda")
        counts = torch.zeros((SHARDS, 2), dtype=torch.int64, device="cuda")

        def run():
            counts.zero_()   # the wrapper's fresh zeros
            status = lib.mcq_topn_windows(
                cnt.data_ptr(), order.data_ptr(), tot.data_ptr(), SHARDS,
                ROWS, CAP, k, TOP_N, blocks, lists.data_ptr(),
                counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"mcq_topn_windows failed: {status}")

        run()
        want = ref.topn_window_lists_ref(cnt, order, tot, TOP_N, blocks)
        if not (torch.equal(lists, want[0]) and torch.equal(counts, want[1])):
            raise AssertionError(f"window lists at {blocks} blocks differ")
        return run, blocks

    variants, blocks_of = {}, {}
    for name, lib in libs.items():
        variants[name], blocks_of[name] = lists_of(lib)
    got = tw.topn_windows_cuda(*read, n=TOP_N)
    if not all(torch.equal(x, y) for x, y in zip(
            got, ref.topn_windows_ref(*read, TOP_N))):
        raise AssertionError("the read differs from its plain mirror")
    variants["the read (window kernel, merge, srcs' pass)"] = (
        lambda: tw.topn_windows_cuda(*read, n=TOP_N))
    lists, counts = tw.window_lists_cuda(cnt, order, tot, n=TOP_N)
    variants["merge + srcs' pass"] = lambda: tm.merge_windows_cuda(
        lists, counts, order, dst, keys, vals, n=TOP_N,
        blocks=tw.blocks_for(cnt, TOP_N))
    cnt_k = torch.gather(cnt, 2, order[:, :, :k].long())
    prob = torch.where(cnt_k > 0, cnt_k.float()
                       / tot.clamp(min=1).float().unsqueeze(2),
                       0.0).view(SHARDS, -1)
    del cnt_k
    variants["plain: the windows' stable sort (sh._top_k)"] = (
        lambda: sh._top_k(prob, TOP_N))
    variants["plain: the row -> src scatter (ref.src_of_row_ref)"] = (
        lambda: ref.src_of_row_ref(keys, vals, ROWS))
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    times = {name: [] for name in variants}
    for turn in range(args.turns):
        names = list(variants) if turn % 2 == 0 else list(reversed(variants))
        for name in names:
            times[name].append(time_ms(variants[name], flush))
    result = {"card": card(), "shape": [SHARDS, ROWS, CAP], "n": TOP_N,
              "blocks_a_shard": blocks_of, "turns": args.turns,
              "ms": {name: t for name, t in times.items()}}
    print(f"topn_ablation on {result['card']}: {SHARDS} x {ROWS} x {CAP}, "
          f"n = {TOP_N}; median ms by turn")
    for name, t in times.items():
        at = f" ({blocks_of[name]} blocks a shard)" if name in blocks_of else ""
        print(f"  {name}{at}: " + ", ".join(f"{x:.4f}" for x in t))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
