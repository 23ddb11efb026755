"""Where the time of ``slab_update`` and ``cdf_query`` goes, on an NVIDIA GPU.

Builds copies of ``csrc/slab_update.cu`` and ``csrc/cdf_query.cu``, each with
one part taken out or changed, into a library of its own beside the
package's, and times every copy in turns with the kernel as built, on the
inputs phase main of ``chip_smoke.py`` hands the two kernels (the chain at
2^20 x 128 after its warm-up; 65,536 update items; 4,096 pre-ordered query
rows).  Times are medians of 20 calls by CUDA events, the L2 flushed before
each call (``slab_update`` in place, its ``cnt``/``tot`` restored between
calls), over ``--turns`` turns.  A copy that leaves out a part does not
compute the kernel's function: it says what that part costs.  Each
``slab_update`` copy is also timed on the first 190 update items, the size
of an LM request's drafter update.  ``--baseline`` (the ``csrc/`` of
another checkout, such as the parent commit's) adds its two kernels.

    python3 scripts/kernel_ablation.py [--turns 3] [--baseline DIR] [--out FILE.json]

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

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT_DIR = ROOT / "build" / "ablation"


def _sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"ablation anchor not found in the source: {old!r}")
    return text.replace(old, new)


def _replace_kernel(text, head, tail, body):
    """``text`` with the span from ``head`` up to ``tail`` replaced."""
    a, b = text.index(head), text.index(tail)
    return text[:a] + body + text[b:]


def slab_variants(src):
    """name -> source of ``slab_update.cu`` with one part changed."""
    items_only = '''template <bool kVec>
__global__ void mcq_slab_update_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ dsts,
    const int32_t* __restrict__ w, const int32_t* __restrict__ dst_slab,
    int32_t* cnt, int32_t* tot, uint8_t* __restrict__ dirty, int batch,
    int capacity, int tile) {
  const long long i = blockIdx.x * static_cast<long long>(tile) +
                      threadIdx.x;
  if (threadIdx.x >= tile) return;
  if (i >= batch) return;
  const int32_t r = __ldg(rows + i), d = __ldg(dsts + i), x = __ldg(w + i);
  if (r == -7 && d == -7 && x == -7) tot[0] = 1;
}

'''
    cnt_atomic = ("  if (found)\n    atomicAdd(cnt + static_cast<size_t>(row) "
                  "* capacity + own, wi);\n")
    tot_atomic = "    atomicAdd(tot + row, static_cast<int32_t>(sum));\n"
    return {
        "slab_update": src,
        "slab_update: the items' trip alone": _replace_kernel(
            src, "template <bool kVec>\n__global__", "// Items per warp:",
            items_only),
        "slab_update: no atomics or flags (the two trips)": _replace_kernel(
            src, cnt_atomic, "// Items per warp:",
            "  if (found && wi == -12345) cnt[0] = own;\n}\n\n"),
        "slab_update: no row scan (slot 0)": _sub(_sub(
            src, "s0 < capacity && __any_sync", "false && __any_sync"),
            "const bool found = row >= 0 && own < capacity;",
            "own = 0;\n  const bool found = row >= 0;"),
        "slab_update: no cnt atomic": _sub(
            src, cnt_atomic, "  if (found && wi == -12345) cnt[0] = own;\n"),
        "slab_update: no tot atomic": _sub(
            src, tot_atomic, "    if (sum == 0x7fffffffu) tot[0] = 1;\n"),
        "slab_update: 16 slots per step (4 lanes per item)": _sub(
            src, "#define MCQ_SU_GROUP 8", "#define MCQ_SU_GROUP 4"),
        "slab_update: 8 slots per step (2 lanes per item)": _sub(
            src, "#define MCQ_SU_GROUP 8", "#define MCQ_SU_GROUP 2"),
        "slab_update: 32 items per warp": _sub(
            src, "  int tile = MCQ_WARP;\n", "  return 32;\n  int tile = MCQ_WARP;\n"),
        "slab_update: 16 items per warp": _sub(
            src, "  int tile = MCQ_WARP;\n", "  return 16;\n  int tile = MCQ_WARP;\n"),
        "slab_update: 8 items per warp": _sub(
            src, "  int tile = MCQ_WARP;\n", "  return 8;\n  int tile = MCQ_WARP;\n"),
        "slab_update: 4 items per warp": _sub(
            src, "  int tile = MCQ_WARP;\n", "  return 4;\n  int tile = MCQ_WARP;\n"),
        "slab_update: 2 items per warp": _sub(
            src, "  int tile = MCQ_WARP;\n", "  return 2;\n  int tile = MCQ_WARP;\n"),
        "slab_update: 1 item per warp": _sub(
            src, "  int tile = MCQ_WARP;\n", "  return 1;\n  int tile = MCQ_WARP;\n"),
        "slab_update: cnt/tot lines prefetched to L2 after the items' trip":
            _sub(src, "  // the group's 8 items", '''  if (row >= 0) {
    asm volatile("prefetch.global.L2 [%0];" :: "l"(tot + row));
    asm volatile("prefetch.global.L2 [%0];"
                 :: "l"(cnt + static_cast<size_t>(row) * capacity));
  }
  // the group's 8 items'''),
    }


def cdf_variants(src):
    """name -> source of ``cdf_query.cu`` with one part changed."""
    tot_only = '''template <int V, bool kVec>
__global__ void __launch_bounds__(MCQ_CDF_WARPS * MCQ_WARP)
    mcq_cdf_query_kernel(const int32_t* __restrict__ c_ord,
                         const int32_t* __restrict__ d_ord,
                         const int32_t* __restrict__ tot, float t, int topk,
                         int32_t* __restrict__ dst_out,
                         float* __restrict__ prob_out,
                         int32_t* __restrict__ n_out, int batch, int capacity,
                         int max_items) {
  const long long q = static_cast<long long>(blockIdx.x) * MCQ_CDF_WARPS +
                      (threadIdx.x / MCQ_WARP);
  if (q >= batch) return;
  if ((threadIdx.x & (MCQ_WARP - 1)) == 0) n_out[q] = __ldg(tot + q);
}

'''
    emit = "    mcq_cdf_emit<V>(c, d, mask, j0, capacity, totf, max_items, dq, pq);\n"
    vector_emit = '''    if (V == 4 && (max_items & 3) == 0 && j0 + 4 <= emit) {
      int4 dv;
      float4 pv;
      int32_t* dd = reinterpret_cast<int32_t*>(&dv);
      float* pp = reinterpret_cast<float*>(&pv);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const bool need = (mask >> (v & (V - 1))) & 1u;
        dd[v] = need ? d[v & (V - 1)] : MCQ_EMPTY;
        pp[v] = need ? __fdiv_rn(__int2float_rn(c[v & (V - 1)]), totf) : 0.0f;
      }
      *reinterpret_cast<int4*>(dq + j0) = dv;
      *reinterpret_cast<float4*>(pq + j0) = pv;
    } else {
  ''' + emit + "    }\n"
    return {
        "cdf_query": src,
        "cdf_query: tot's trip alone": _replace_kernel(
            src, "template <int V, bool kVec>\n__global__",
            "template <int V>\nstatic void", tot_only),
        "cdf_query: no emission (loads and scan)": _sub(_sub(
            src, emit, "    if (mask == 0xdeadbeefu) dq[0] = d[0];\n"),
            "  mcq_cdf_fill_tail(s0 < capacity ? s0 : capacity, max_items, "
            "dq, pq);\n", ""),
        "cdf_query: V = 1 in threshold mode": _sub(
            src, "  if (capacity <= 32) MCQ_CDF_CASE(1);",
            "  if (capacity <= 32 || topk == 0) MCQ_CDF_CASE(1);"),
        "cdf_query: 8 warps per block": _sub(
            src, "#define MCQ_CDF_WARPS 4", "#define MCQ_CDF_WARPS 8"),
        "cdf_query: 16-B stores of dsts and probs": _sub(src, emit, vector_emit),
    }


def build(variants, includes, out_dir=OUT_DIR):
    """Compile every variant (one nvcc each, all started together) into a
    shared library of its own under ``out_dir``, with the headers of
    ``includes[name]`` (the package's ``csrc/`` where not given); name ->
    ctypes library, its entries typed as the package's."""
    import chip_smoke as cs
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = []
    for i, (name, text) in enumerate(variants.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        jobs.append((name, so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I",
             str(includes.get(name, CSRC)), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        for line in cs.ptxas_summary(log):
            cs.say(f"[ablation] {name}: {line}")
        lib = ctypes.CDLL(str(so))
        for entry in _build.SIGNATURES:
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.argtypes = _build.SIGNATURES[entry]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", type=Path,
                    help="another checkout's csrc/ whose slab_update.cu and "
                         "cdf_query.cu are timed beside these")
    ap.add_argument("--out", help="write the medians here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import mcprioq as mc

    card = cs.phase_device()
    variants = {**slab_variants((CSRC / "slab_update.cu").read_text()),
                **cdf_variants((CSRC / "cdf_query.cu").read_text())}
    includes = {}
    if args.baseline:
        for name in ("slab_update", "cdf_query"):
            variants[f"{name} (baseline)"] = (
                args.baseline / f"{name}.cu").read_text()
            includes[f"{name} (baseline)"] = args.baseline
    libs = build(variants, includes)
    state, cfg, traffic, _, _ = cs.phase_main(args.seed, 4400, 20)
    # the inputs update_batch_ and the unfused read hand the two kernels
    src, dst = traffic.batch(cs.BATCH)
    src, dst, w, m = mc._batch_inputs(state, src, dst, None, None)
    u_src, u_dst, u_w, u_act, _ = mc._aggregate_batch(src, dst, w, m)
    rows0, found_src0 = mc.lookup_rows(state, u_src, cfg)
    _, found_d0 = mc._find_slots(state, rows0, u_dst, cfg)
    fast = u_act & found_src0 & found_d0
    rows = torch.where(fast, rows0, -1)
    slabs = state.slabs
    hit = mc.ht.first_true(slabs.dst[rows0.long()] == u_dst.unsqueeze(1),
                           dim=1)[0][fast].float()
    cs.say(f"[ablation] update items found {int(fast.sum())} of {cs.BATCH}; "
           f"their slot: mean {float(hit.mean()):.2f}, share >= 8 "
           f"{float((hit >= 8).float().mean()):.4f}, >= 16 "
           f"{float((hit >= 16).float().mean()):.4f}, >= 32 "
           f"{float((hit >= 32).float().mean()):.4f}, max {int(hit.max())}")
    q = traffic.srcs(cs.QUERIES)
    c_u, d_u, tot_u, _ = mc._ordered_rows(state, q, cfg)
    n, c = slabs.cnt.shape
    cnt, tot = slabs.cnt.clone(), slabs.tot.clone()
    dirty = torch.zeros(n, dtype=torch.uint8, device="cuda")
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def restore():
        cnt.copy_(slabs.cnt)
        tot.copy_(slabs.tot)
        dirty.zero_()

    def slab(lib, flags=True, items=None):
        b = rows.numel() if items is None else items
        return lambda: lib.mcq_slab_update(
            rows.data_ptr(), u_dst.data_ptr(), u_w.data_ptr(),
            slabs.dst.data_ptr(), cnt.data_ptr(), tot.data_ptr(),
            dirty.data_ptr() if flags else None, b, c, stream())

    def cdf(lib, t, k):
        dk = torch.empty((q.numel(), k), dtype=torch.int32, device="cuda")
        pk = torch.empty((q.numel(), k), dtype=torch.float32, device="cuda")
        nn = torch.empty(q.numel(), dtype=torch.int32, device="cuda")
        return lambda: lib.mcq_cdf_query(
            c_u.data_ptr(), d_u.data_ptr(), tot_u.data_ptr(),
            0.0 if t is None else t, int(t is None), dk.data_ptr(),
            pk.data_ptr(), nn.data_ptr(), q.numel(), c, k, stream())

    cases = [("launch floor (an empty kernel)",
              lambda: cs.time_ms(lambda: torch.cuda._sleep(0), reps=20,
                                 flush=flush))]
    for items in (None, 190):
        tag = "" if items is None else " [190 items]"
        for name, lib in libs.items():
            if name.startswith("slab_update"):
                cases.append((name + tag, lambda lib=lib, items=items:
                              cs.time_restored(slab(lib, items=items),
                                               restore, flush, reps=20)))
    cases.append(("slab_update: no dirty flags", lambda: cs.time_restored(
        slab(libs["slab_update"], flags=False), restore, flush, reps=20)))
    for name, lib in libs.items():
        if name.startswith("cdf_query"):
            for t, k in ((0.9, 16), (None, 8)):
                mode = f"t = {t}, k = {k}" if t is not None else f"top-k {k}"
                cases.append((f"{name} [{mode}]", lambda lib=lib, t=t, k=k:
                              cs.time_ms(cdf(lib, t, k), reps=20, flush=flush)))
    times = {name: [] for name, _ in cases}
    for _ in range(args.turns):
        for name, run in cases:
            times[name].append(run())
    result = {"device": card, "turns": args.turns,
              "ms": {name: statistics.median(v) for name, v in times.items()},
              "ms_by_turn": times}
    for name, v in times.items():
        cs.say(f"[ablation] {name}: {statistics.median(v):.4f} ms "
               f"(turns {', '.join(f'{x:.4f}' for x in v)})")
    cs.say(card)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
