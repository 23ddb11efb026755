"""Where the time of the odd-even kernel goes, on an NVIDIA GPU.

Builds copies of ``csrc/oddeven.cu``, each with one part of its design taken
out or changed, and the one-warp-a-row kernel it replaced
(``scripts/baseline_kernels.cu``), each into a library of its own, and
times them in turns on the shapes the paths hand the kernel: the soak's
2^19 x 16, the drafter's 2^20 x 64, the chain's 2^20 x 128 and the LM
drafter's 8,192 x 64.  Counts are random with ties, each row's order sorted
by them but for one inversion in 2 % of the rows, so the in-place form
writes back about as many rows as on a path.  Times are medians of 20 calls
by CUDA events, the L2 flushed before each by rewriting 256 MiB, as
``chip_smoke.py`` does (in place: ``order`` restored between calls, not
timed), the variants in turns; the kernel and the one it replaced also
after a flush that only reads (the L2 left clean, so no write-back of the
flush's lines falls into the call).  Every variant is held equal to the
kernel as built first.

    python3 scripts/oddeven_ablation.py [--out FILE.json]

It needs a CUDA device and ``nvcc``, and exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
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
SHAPES = ((2 ** 19, 16, "soak"), (2 ** 20, 64, "drafter"),
          (2 ** 20, 128, "main"), (8192, 64, "lm"))


def variants(src):
    """name -> source of ``oddeven.cu`` with one part changed."""
    from kernel_ablation import _sub
    return {
        "oddeven": src,
        "one row ahead up to C = 64 (the next row's loads alone in flight)":
            _sub(src, """        c4[u0] = x0;
        x0 = x1;
        if (row + 2 * stride < num_rows) x1 = unit(row + 2 * stride, u0);""",
                 """        c4[u0] = x0;
        if (row + stride < num_rows) x0 = unit(row + stride, u0);"""),
        "a block per rows (the grid not capped, no row loop)": _sub(
            src, """  if (blocks > static_cast<long long>(sms) * per_sm)
    blocks = static_cast<long long>(sms) * per_sm;""", ""),
    }


def case(n, c, seed=0):
    """cnt [n, c] (ties), order sorted by it but for one inversion in 2 % of
    the rows."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    cnt = torch.randint(0, 50, (n, c), generator=g, device="cuda",
                        dtype=torch.int32)
    order = torch.sort(-cnt.long(), dim=1, stable=True).indices.to(torch.int32)
    if c > 1:
        bad = torch.rand(n, generator=g, device="cuda") < 0.02
        swapped = order[:, [1, 0]]
        order[:, :2] = torch.where(bad.unsqueeze(1), swapped, order[:, :2])
    return cnt, order.contiguous()


def clean_ms(fn, restore, flush, reps=20, warm=3):
    """Median ms of ``fn()`` by CUDA events, each call after ``restore()``
    and a read of ``flush`` (L2 full of clean lines; neither timed)."""
    times = []
    for rep_ in range(warm + reps):
        restore()
        torch.sum(flush)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if rep_ >= warm:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--turns", type=int, default=1,
                    help="times over every shape")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FILE", help="another source of oddeven.cu "
                    "to time beside them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("oddeven_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kernel_ablation import build
    vs = variants((CSRC / "oddeven.cu").read_text())
    for spec in args.variant:
        name, path = spec.split("=", 1)
        vs[name] = Path(path).read_text()
    vs["the one-warp-a-row kernel it replaced"] = (
        ROOT / "scripts" / "baseline_kernels.cu").read_text()
    libs = build(vs, {})
    entry = {name: (lib.mcq_base_oddeven if "replaced" in name
                    else lib.mcq_oddeven) for name, lib in libs.items()}
    p = ctypes.c_void_p
    for fn in entry.values():
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    results = []
    for n, c, path in [s for _ in range(args.turns) for s in SHAPES]:
        cnt, order = case(n, c)
        work = order.clone()
        dirty = torch.zeros(n, dtype=torch.uint8, device="cuda")
        out = torch.empty_like(order)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn, in_place):
            status = fn(cnt.data_ptr(), work.data_ptr(),
                        (work if in_place else out).data_ptr(),
                        dirty.data_ptr() if in_place else None, n, c, 1,
                        stream)
            if status:
                raise RuntimeError(f"launch failed: {status}")

        def restore():
            work.copy_(order)
            dirty.zero_()

        want = None
        for name, fn in entry.items():
            restore()
            call(fn, True)
            got = (work.clone(), dirty.clone())
            if want is None:
                want = got
            elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} differs from the kernel at "
                                     f"{n} x {c}")
        for in_place in (True, False):
            names = list(entry)
            ms = cs.paired_restored(
                [lambda f=entry[k]: call(f, in_place) for k in names],
                restore, flush, reps=20, warm=3)
            bound_ms = (4 * 2 * n * c + 4 * (n * c if not in_place else
                                              int(want[1].sum()) * c)) \
                / cs.HBM_BYTES_PER_S * 1e3
            for name, t in zip(names, ms):
                cs.say(f"[ablation] {path} {n} x {c} "
                       f"{'in place' if in_place else 'functional'}: {name}: "
                       f"{t:.4f} ms (bound {bound_ms:.4f})")
                results.append(dict(path=path, rows=n, capacity=c,
                                    in_place=in_place, variant=name, ms=t,
                                    bound_ms=bound_ms))
            # the L2 left clean (the flush read, not written) instead: the
            # dirty flush's lines are written back during the timed call
            for name in ("oddeven", "the one-warp-a-row kernel it replaced"):
                t = clean_ms(lambda f=entry[name]: call(f, in_place), restore,
                             flush)
                cs.say(f"[ablation] {path} {n} x {c} "
                       f"{'in place' if in_place else 'functional'}: {name}, "
                       f"L2 flushed clean: {t:.4f} ms (bound {bound_ms:.4f})")
                results.append(dict(path=path, rows=n, capacity=c,
                                    in_place=in_place, variant=name,
                                    clean_flush=True, ms=t, bound_ms=bound_ms))
    cs.say(f"[ablation] {card}")
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
