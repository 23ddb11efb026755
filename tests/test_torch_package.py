"""Package-level contracts of the port: it imports without jax or repro, it
never falls back to the CPU or from a kernel to its plain version, and every
kernel module carries its wrapper, plain version, launch count and CUDA
source (checked by reading the files: nothing can be compiled without nvcc)."""

import ast
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import expert_monitor as tem
from repro_torch.core import hashtable as tht
from repro_torch.core import mcprioq as tmc
from repro_torch.core import sharded as tsh
from repro_torch.core import slab as tsl
from repro_torch.core.device import resolve_device
from repro_torch.kernels import _build, ops

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {
    # module: (wrapper, plain version, .cu file, C entry point)
    "probe": ("probe_find_cuda", "probe_find_ref", "probe.cu", "mcq_probe_find"),
    "slab_update": ("slab_update_cuda", "slab_update_ref", "slab_update.cu",
                    "mcq_slab_update"),
    "oddeven": ("oddeven_cuda", "oddeven_sort_ref", "oddeven.cu", "mcq_oddeven"),
    "cdf_gather": ("cdf_query_fused_cuda", "cdf_query_fused_ref", "cdf_gather.cu",
                   "mcq_cdf_query_fused"),
    "slow_path": ("slow_path_cuda", "slow_path_ref", "slow_path.cu", "mcq_slow_path"),
    "cdf_query": ("cdf_query_cuda", "cdf_query_ref", "cdf_query.cu", "mcq_cdf_query"),
    "walk": ("draft_walk_cuda", "draft_walk_ref", "walk.cu", "mcq_draft_walk"),
    "decay_sort": ("decay_sort_cuda", "decay_sort_ref", "decay_sort.cu",
                   "mcq_decay_sort"),
    "copy_rows": ("copy_dirty_rows_cuda", "copy_dirty_rows_ref", "copy_rows.cu",
                  "mcq_copy_dirty_rows"),
    "dh_rebuild": ("dh_rebuild_cuda_", "dh_rebuild_ref_", "dh_rebuild.cu",
                   "mcq_dh_rebuild"),
    "topn_merge": ("topn_merge_cuda", "topn_merge_ref", "topn_merge.cu",
                   "mcq_topn_merge"),
}


def _module_names():
    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_every_module_imports_without_jax_or_the_reference_package():
    names = _module_names()
    assert "repro_torch.kernels.ops" in names and "repro_torch.convert" in names
    assert "repro_torch.chaos.soak" in names
    script = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')"
        " or m == 'tools' or m.startswith('tools.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def _assert_imports_nothing_of_the_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "tools", "triton"), \
                (path, mod)


@pytest.mark.parametrize("name", _module_names())
def test_no_source_file_mentions_jax_or_repro_imports(name):
    _assert_imports_nothing_of_the_reference(
        Path(importlib.import_module(name).__file__))


@pytest.mark.parametrize("path", sorted(
    (ROOT / "examples").glob("torch_*.py")), ids=lambda p: p.name)
def test_port_examples_import_nothing_of_the_reference(path):
    """The port's examples (and the soak they run) import the port only:
    no jax, no ``repro.``, no ``tools.``."""
    _assert_imports_nothing_of_the_reference(path)
    assert "repro_torch" in path.read_text()


def test_init_without_a_cuda_device_raises_and_never_returns_a_cpu_state():
    assert not torch.cuda.is_available(), "this test describes a machine without a GPU"
    cfg = tmc.MCConfig(num_rows=8, capacity=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmc.init(cfg)
    state = tmc.init(cfg, device="cpu")
    assert state.slabs.cnt.device.type == "cpu"
    assert tmc.resolve_device is resolve_device
    assert all(getattr(state, f).dtype == torch.int32 and getattr(state, f).dim() == 0
               for f in tmc._COUNTER_FIELDS + ("decay_cursor",))


@pytest.mark.parametrize("call", [
    lambda x, v: ops.oddeven_sort(x, x, impl="cuda"),
    lambda x, v: ops.slab_update(v, v, v, x, x, v, impl="cuda"),
    lambda x, v: ops.decay_sort(x, x, x, impl="cuda"),
    lambda x, v: ops.decay_sort_rolling(x, x, x, v, v[0], block_rows=2,
                                        impl="cuda"),
    lambda x, v: ops.dh_find(v, v, x, x, impl="cuda"),
    lambda x, v: ops.ht_find(v, v, v, impl="cuda"),
    lambda x, v: ops.ht_find(v, v, v, miss=0, impl="cuda"),
    lambda x, v: ops.cdf_query_fused(v, v, x, x, x, v, 0.5, impl="cuda"),
    lambda x, v: ops.slow_path(v, v, x, x, v, x, v, v, v, v, v, impl="cuda"),
    lambda x, v: ops.cdf_query(x, x, v, 0.5, impl="cuda"),
    lambda x, v: ops.draft_walk(x, v, v, x, x, v, impl="cuda"),
    lambda x, v: ops.oddeven_sort_(x, x, impl="cuda"),
    lambda x, v: ops.slab_update_(v, v, v, x, x, v, impl="cuda"),
    lambda x, v: ops.decay_sort_(x, x, x, v, impl="cuda"),
    lambda x, v: ops.decay_sort_rolling_(x, x, x, v, v[0], block_rows=2,
                                         impl="cuda"),
    lambda x, v: ops.slow_path_(v, v, x, x, v, x, v, v, v, v, v, impl="cuda"),
    lambda x, v: ops.copy_dirty_rows((x, x, x, v, v, v, v), (x, x, x, v, v, v, v),
                                     v.to(torch.uint8), impl="cuda"),
    lambda x, v: ops.dh_rebuild_(x, x, x, x, v[:2], threshold=0, impl="cuda"),
    lambda x, v: ops.topn_merge(x.float(), x, x, n=3, impl="cuda"),
])
def test_impl_cuda_on_cpu_tensors_raises(call):
    x = torch.zeros((4, 4), dtype=torch.int32)
    v = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call(x, v)


@pytest.mark.parametrize("module", list(KERNELS))
def test_cuda_wrapper_refuses_cpu_tensors_instead_of_falling_back(module):
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    wrapper = getattr(mod, KERNELS[module][0])
    x = torch.zeros((4, 4), dtype=torch.int32)
    v = torch.zeros((4,), dtype=torch.int32)
    args = {"probe": (v, v, x, x), "slab_update": (v, v, v, x, x, v),
            "oddeven": (x, x), "cdf_gather": (v, v, x, x, x, v, 0.5),
            "slow_path": (v, v, x, x, v, x, v, v, v, v, v),
            "cdf_query": (x, x, v, 0.5), "walk": (x, v, v, x, x, v),
            "decay_sort": (x, x, x),
            "copy_rows": (x, x, x, v, v, v, v, x, x, x, v, v, v, v,
                          v.to(torch.uint8)),
            "dh_rebuild": (x, x, x, x, v[:2]),
            "topn_merge": (x.float(), x, x)}[module]
    before = mod.launches
    with pytest.raises(ValueError, match="takes CUDA"):
        wrapper(*args, **{"dh_rebuild": {"threshold": 0},
                          "topn_merge": {"n": 3}}.get(module, {}))
    assert mod.launches == before


def test_state_on_cpu_with_impl_cuda_raises_in_update_and_query():
    cfg = tmc.MCConfig(num_rows=8, capacity=4, impl="cuda")
    state = tmc.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tmc.update_batch(state, [1, 2], [3, 4], cfg=cfg)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tmc.query_threshold(state, [1], 0.5, cfg=cfg)


@pytest.mark.parametrize("impl", ["pallas", "triton", "vmap", ""])
def test_config_rejects_unknown_impl(impl):
    with pytest.raises(ValueError, match="impl must be one of"):
        tmc.MCConfig(impl=impl)


@pytest.mark.parametrize("kw", [dict(use_dst_hash=True),
                                dict(use_dst_hash=True, fused_query=False)])
def test_options_of_later_slices_raise_not_implemented(kw):
    """The dst hash, the last option a later slice owed, no longer raises:
    the option is accepted, and an update and a read (fused or not) run
    on the CPU, through the row hashes."""
    cfg = tmc.MCConfig(num_rows=8, capacity=4, **kw)
    state = tmc.init(cfg, device="cpu")
    assert state.dh_keys.shape == (8, 16)
    state = tmc.update_batch(state, [1, 2, 1], [3, 4, 5], cfg=cfg)
    assert int((state.dh_keys >= 0).sum()) == 3
    dk, pk, nn = tmc.query_threshold(state, [1, 2, 9], 1.0, cfg=cfg)
    assert nn.tolist() == [2, 1, 0] and sorted(dk[0, :2].tolist()) == [3, 5]
    assert tmc.check_invariants(state, cfg)["dst_hash_consistent"]


def _tensors(x):
    """Every tensor of a (nested) tuple of tensors."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _tensors(y)]


@pytest.mark.parametrize("make", [
    lambda d: tht.make(8, device=d), lambda d: tsl.make(4, 3, device=d),
    lambda d: tsh.init_sharded(tsh.ShardedConfig(
        base=tmc.MCConfig(num_rows=8, capacity=4), num_shards=3), device=d),
    lambda d: tem.init(tem.MonitorConfig(num_layers=2, num_experts=5), device=d),
], ids=["hashtable", "slab", "sharded", "expert_monitor"])
def test_constructors_default_to_the_gpu_and_never_to_the_cpu(make):
    assert not torch.cuda.is_available(), "this test describes a machine without a GPU"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(None)
    assert all(x.device.type == "cpu" for x in _tensors(make("cpu")))


@pytest.mark.parametrize("module", list(KERNELS))
def test_kernel_module_has_wrapper_plain_version_count_and_source(module):
    wrapper, plain, cu, entry = KERNELS[module]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert callable(getattr(mod, wrapper)) and callable(getattr(mod, plain))
    assert isinstance(mod.launches, int)
    assert "Replaces" in mod.__doc__ and "Bound on this card" in mod.__doc__
    source = (_build.CSRC / cu).read_text()
    assert re.search(rf'extern "C" int {entry}\(', source), entry
    assert "__global__" in source and "<<<" in source
    assert entry in _build.SIGNATURES
    # the count moves only where the kernel is launched
    text = Path(mod.__file__).read_text()
    assert text.count("launches += 1") == 1
    assert text.index("_build.launch(") < text.index("launches += 1")
    # one argument type per C parameter
    params = re.search(rf'extern "C" int {entry}\((.*?)\)', source, re.S).group(1)
    assert len(params.split(",")) == len(_build.SIGNATURES[entry])


def test_build_is_keyed_by_sources_and_targets_sm_90a(tmp_path):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    cu, cuh = _build.sources()
    assert {p.name for p in cu} == {k[2] for k in KERNELS.values()}
    assert {p.name for p in cuh} == {"common.cuh", "cdf_walk.cuh", "probe.cuh",
                                     "probe_window.cuh"}
    assert re.fullmatch(r"[0-9a-f]{16}", _build.source_hash())
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert not any("torch" in line for p in cu + cuh
                   for line in p.read_text().splitlines() if line.startswith("#include"))


def test_chip_smoke_parses_and_imports_nothing_of_the_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert "repro_torch" in imported
    assert not imported & {"jax", "jaxlib", "repro", "tools"}


_BUILD_RACE = """
import sys, time
from pathlib import Path
from repro_torch.kernels import _build
build, log = Path(sys.argv[1]), Path(sys.argv[2])
_build.BUILD_DIR = build

def compile_(lib_path):          # nvcc stands in: slow, then the library
    with open(log, "a") as f:
        f.write("built\\n")
    time.sleep(1.0)
    lib_path.write_bytes(b"")

class Lib:                       # ctypes stands in: every entry point
    def __getattr__(self, name):
        return type("Fn", (), {})()

_build._compile = compile_
_build.ctypes.CDLL = lambda path: Lib()
Path(sys.argv[3]).touch()        # started
while not Path(sys.argv[4]).exists():
    time.sleep(0.01)             # both start the load together
_build.load()
print("loaded")
"""


def test_processes_loading_together_build_the_library_once(tmp_path):
    """Soak workers start together on a machine where the library is not
    built yet: ``_build.load`` takes an exclusive lock, so the first
    builds and the other finds its library."""
    log, go = tmp_path / "builds.log", tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_RACE, str(tmp_path / "build"), str(log),
         str(tmp_path / f"started{i}"), str(go)],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for i in range(2):
        while not (tmp_path / f"started{i}").exists():
            assert procs[i].poll() is None, procs[i].communicate()[1]
    go.touch()
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0 and out.strip() == "loaded", err
    assert log.read_text().splitlines() == ["built"]


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _kernel_stand_ins(probe_calls, decay_calls):
    """Each CUDA wrapper replaced by its plain version behind a check of what
    the wrapper takes: int32 tensors, but bool where the wrapper takes bool
    (the fused read's ``found``, the decay's ``fire``), float32 for the
    merge's probabilities and uint8 for the ``dirty`` flags, contiguous
    except where the wrapper passes a stride to
    its kernel (the draft walk's window and order heads).  The probe's
    stand-in also checks its table against its mode (flat ``[H]`` when
    ``rows`` is None, stacked ``[N, H]`` otherwise) and records ``(flat,
    miss)`` of each call in ``probe_calls``; the decay stand-ins record
    ``(rows, block_rows)`` in ``decay_calls`` (``block_rows`` None for the
    whole-table forms) and the rolling ones check that their cursor is the
    state's 0-dim int32 tensor.  Keyword tensors (the row hashes and their
    tombstone count, the rebuild's and the learner's) are int32 and
    contiguous too."""
    from repro_torch.kernels import (cdf_gather, cdf_query, copy_rows,
                                     decay_sort, dh_rebuild, oddeven, probe,
                                     ref, slab_update, slow_path, topn_merge,
                                     walk)

    def check(name, strided, plain, bools=(), floats=()):
        def wrapper(*args, **kw):
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor):
                    want = (torch.bool if i in bools else
                            torch.float32 if i in floats else
                            torch.uint8 if name == "copy_rows" and i == 14
                            else torch.int32)
                    assert a.dtype == want, (name, i, a.dtype)
                    assert i in strided or a.is_contiguous(), (name, i)
            for key, value in kw.items():
                for a in value if isinstance(value, tuple) else (value,):
                    if isinstance(a, torch.Tensor):
                        want = {"fire": torch.bool, "dirty": torch.uint8}.get(
                            key, torch.int32)
                        assert a.dtype == want and a.is_contiguous(), (name, key)
            return plain(*args, **kw)
        return wrapper

    def probe_plain(rows, keys_q, keys, vals, *, max_probes, miss=-1):
        assert keys.dim() == (1 if rows is None else 2), (rows is None, keys.shape)
        probe_calls.append((rows is None, miss))
        return ref.probe_find_ref(rows, keys_q, keys, vals, max_probes, miss)

    def decay_plain(cnt, dst, order, **dh):
        decay_calls.append((cnt.shape[0], None))
        return ref.decay_sort_ref(cnt, dst, order, **dh)

    def decay_plain_(cnt, dst, order, tot, *, fire=None, dirty=None, **dh):
        assert fire is None or fire.dim() == 0, fire
        decay_calls.append((cnt.shape[0], None))
        ref.decay_sort_ref_(cnt, dst, order, tot, fire, dirty, **dh)

    def rolling_plain(cnt, dst, order, tot, cursor, *, block_rows, **dh):
        assert cursor.dim() == 0 and cursor.device == cnt.device, cursor
        decay_calls.append((cnt.shape[0], block_rows))
        return ref.decay_sort_rolling_ref(cnt, dst, order, tot, cursor,
                                          block_rows, **dh)

    def rolling_plain_(cnt, dst, order, tot, cursor, *, block_rows, fire=None,
                       dirty=None, **dh):
        assert cursor.dim() == 0 and cursor.device == cnt.device, cursor
        decay_calls.append((cnt.shape[0], block_rows))
        ref.decay_sort_rolling_ref_(cnt, dst, order, tot, cursor, block_rows,
                                    fire, dirty, **dh)

    def rebuild_plain_(cnt, dst, keys, vals, counters, *, threshold,
                       max_probes, fire=None, dirty=None):
        assert counters.shape == (2,) and isinstance(threshold, int)
        decay_calls.append((cnt.shape[0], "rebuild"))
        ref.dh_rebuild_ref_(cnt, dst, keys, vals, counters, threshold,
                            max_probes, fire, dirty)

    return [
        (probe, "probe_find_cuda", check("probe", (), probe_plain)),
        (slab_update, "slab_update_cuda", check(
            "slab_update", (), lambda *a: ref.slab_update_ref(*a)[1:3])),
        (slab_update, "slab_update_cuda_", check(
            "slab_update_", (), lambda *a, dirty=None: ref.slab_update_ref_(
                *a, dirty))),
        (oddeven, "oddeven_cuda", check(
            "oddeven", (), lambda c, o, *, passes: ref.oddeven_sort_ref(c, o, passes))),
        (oddeven, "oddeven_cuda_", check(
            "oddeven_", (), lambda c, o, *, passes, dirty=None:
            ref.oddeven_sort_ref_(c, o, passes, dirty))),
        (cdf_gather, "cdf_query_fused_cuda", check(
            "cdf_gather", (), lambda *a, max_items: ref.cdf_query_fused_ref(*a, max_items),
            bools=(1,))),
        (slow_path, "slow_path_cuda", check(
            "slow_path", (), lambda *a, max_probes, dh_keys=None, dh_vals=None:
            ref.slow_path_ref(*a[:-1], a[-1].to(torch.bool), max_probes,
                              dh_keys, dh_vals))),
        (slow_path, "slow_path_cuda_", check(
            "slow_path_", (), lambda *a, max_probes, dirty=None, dh_keys=None,
            dh_vals=None: ref.slow_path_ref_(
                *a[:-1], a[-1].to(torch.bool), max_probes, dirty, dh_keys,
                dh_vals))),
        (cdf_query, "cdf_query_cuda", check(
            "cdf_query", (), lambda *a, max_items: ref.cdf_query_ref(*a, max_items))),
        (walk, "draft_walk_cuda", check("walk", (0, 5), lambda *a, **kw: (
            lambda t, o: (t, o.to(torch.bool)))(*ref.draft_walk_ref(*a, **kw)))),
        (decay_sort, "decay_sort_cuda", check("decay_sort", (), decay_plain)),
        (decay_sort, "decay_sort_cuda_", check("decay_sort_", (), decay_plain_)),
        (decay_sort, "decay_sort_rolling_cuda", check(
            "decay_sort_rolling", (), rolling_plain)),
        (decay_sort, "decay_sort_rolling_cuda_", check(
            "decay_sort_rolling_", (), rolling_plain_)),
        (copy_rows, "copy_dirty_rows_cuda", check(
            "copy_rows", (), ref.copy_dirty_rows_ref)),
        (dh_rebuild, "dh_rebuild_cuda_", check("dh_rebuild_", (), rebuild_plain_)),
        (topn_merge, "topn_merge_cuda", check(
            "topn_merge", (), lambda p, d, s, *, n: ref.topn_merge_ref(p, d, s, n),
            floats=(0,))),
    ]


def test_every_path_hands_its_kernels_what_their_wrappers_take(monkeypatch):
    """The update, both reads, both decays and the drafter, functional and
    for the state's owner (``maybe_decay_`` firing and not), and the
    back-buffer learner, with the dispatch sent to stand-ins of the CUDA
    wrappers on CPU tensors: a strided or mistyped argument fails here,
    before it reaches the card."""
    import dataclasses

    from repro_torch.core import speculative as tspec
    from repro_torch.core.epoch import BackBufferLearner, EpochStore
    monkeypatch.setattr(ops, "_use_ref", lambda impl, x: impl == "ref")
    probe_calls, decay_calls = [], []
    for module, name, stand_in in _kernel_stand_ins(probe_calls, decay_calls):
        monkeypatch.setattr(module, name, stand_in)
    ncfg = tspec.NGramConfig(order=2, decay_threshold=4, mc=tmc.MCConfig(
        num_rows=32, capacity=8, max_new_per_batch=16, decay_block_rows=8))
    rng = torch.Generator().manual_seed(0)
    st = tspec.init(ncfg, device="cpu")
    for _ in range(4):
        toks = torch.randint(0, 12, (4, 17), generator=rng, dtype=torch.int32)
        st = tspec.maintain(tspec.observe(st, toks, cfg=ncfg), cfg=ncfg)
    ctx = toks[:, :6]
    for k in (1, 3):
        assert torch.equal(tspec.draft(st, ctx, cfg=ncfg, k=k)[0],
                           tspec.draft_reference(st, ctx, cfg=ncfg, k=k)[0])
    tspec.candidates(st, ctx, 0.9, cfg=ncfg)
    column = toks[:, 3]                          # a strided view of srcs
    for cfg in (ncfg.mc, dataclasses.replace(ncfg.mc, fused_query=False)):
        tmc.query_threshold(st.chain, column, 0.5, cfg=cfg)
        tmc.query_topk(st.chain, column, cfg=cfg, k=3)
    tmc.update_batch(st.chain, column, toks[:, 4], cfg=ncfg.mc)
    decayed = tmc.decay(st.chain, cfg=ncfg.mc)
    assert tmc.maintenance_stats(decayed)["decay_steps"] > 0
    whole = dataclasses.replace(ncfg.mc, decay_block_rows=0)
    tmc.decay(st.chain, cfg=whole)
    # rolling decays hand the kernel the whole state and the cursor tensor;
    # stop-the-world is the one whole-table launch
    assert decay_calls[-2:] == [(32, 8), (32, None)], decay_calls
    assert set(decay_calls) == {(32, 8), (32, None)}, set(decay_calls)
    # the owner calls, with flags, and the back-buffer learner
    own = tmc.private_copy(st.chain)
    dirty = torch.zeros(32, dtype=torch.uint8)
    tmc.update_batch_(own, column, toks[:, 4], cfg=ncfg.mc, dirty=dirty)
    for cfg in (ncfg.mc, whole):
        tmc.decay_(own, cfg=cfg, dirty=dirty)
        for threshold in (0, 2 ** 30):           # fires, and does not
            tmc.maybe_decay_(own, cfg=cfg, total_threshold=threshold,
                             dirty=dirty)
    learner = BackBufferLearner(EpochStore(tspec.init(ncfg, device="cpu")))
    for _ in range(3):
        learner.write(lambda s, dirty: tspec.maintain_(tspec.observe_(
            s, toks, cfg=ncfg, dirty=dirty), cfg=ncfg, dirty=dirty))
    assert set(decay_calls) == {(32, 8), (32, None)}, set(decay_calls)
    # every src lookup (update, both reads, candidates) is the flat probe
    # with lookup_rows' miss value 0: one launch, nothing around it
    assert probe_calls and set(probe_calls) == {(True, 0)}, set(probe_calls)


@pytest.mark.parametrize("block", [8, 0], ids=["rolling", "stop_the_world"])
def test_dst_hash_path_hands_its_kernels_what_their_wrappers_take(monkeypatch,
                                                                  block):
    """The same with the dst hash on: the classify's stacked probe, the
    new-edge pass and the decay with the row hashes, the rebuild (forced by
    a threshold of 0 tombstones, and kept off by the highest one), the
    owner calls and the back-buffer learner, through the stand-ins."""
    import dataclasses

    from repro_torch.core import speculative as tspec
    from repro_torch.core.epoch import BackBufferLearner, EpochStore
    monkeypatch.setattr(ops, "_use_ref", lambda impl, x: impl == "ref")
    probe_calls, decay_calls = [], []
    for module, name, stand_in in _kernel_stand_ins(probe_calls, decay_calls):
        monkeypatch.setattr(module, name, stand_in)
    ncfg = tspec.NGramConfig(order=2, decay_threshold=4, mc=tmc.MCConfig(
        num_rows=32, capacity=8, max_new_per_batch=16, decay_block_rows=block,
        use_dst_hash=True, dh_rebuild_fraction=0.0))
    rng = torch.Generator().manual_seed(1)
    st = tspec.init(ncfg, device="cpu")
    for _ in range(4):
        toks = torch.randint(0, 12, (4, 17), generator=rng, dtype=torch.int32)
        st = tspec.maintain(tspec.observe(st, toks, cfg=ncfg), cfg=ncfg)
    column = toks[:, 3]                          # a strided view of srcs
    tmc.update_batch(st.chain, column, toks[:, 4], cfg=ncfg.mc)
    tmc.decay(st.chain, cfg=ncfg.mc)
    own = tmc.private_copy(st.chain)
    dirty = torch.zeros(32, dtype=torch.uint8)
    tmc.update_batch_(own, column, toks[:, 4], cfg=ncfg.mc, dirty=dirty)
    never = dataclasses.replace(ncfg.mc, dh_rebuild_fraction=1.0)
    for cfg in (ncfg.mc, never):
        tmc.decay_(own, cfg=cfg, dirty=dirty)
        for threshold in (0, 2 ** 30):           # fires, and does not
            tmc.maybe_decay_(own, cfg=cfg, total_threshold=threshold,
                             dirty=dirty)
    learner = BackBufferLearner(EpochStore(tspec.init(ncfg, device="cpu")))
    for _ in range(3):
        learner.write(lambda s, dirty: tspec.maintain_(tspec.observe_(
            s, toks, cfg=ncfg, dirty=dirty), cfg=ncfg, dirty=dirty))
    assert tmc.check_invariants(own, ncfg.mc)["dst_hash_consistent"]
    assert tmc.maintenance_stats(own)["dh_rebuilds"] > 0
    # every decay is followed by the rebuild's launch, decided on the device
    kinds = {kind for _, kind in decay_calls}
    assert kinds == {block or None, "rebuild"}, kinds
    # the classify and the invariant are the stacked probe, miss EMPTY
    assert set(probe_calls) == {(True, 0), (False, -1)}, set(probe_calls)


@pytest.mark.parametrize("block", [8, 0], ids=["rolling", "stop_the_world"])
def test_sharded_path_hands_its_kernels_what_their_wrappers_take(monkeypatch,
                                                                 block):
    """The sharded chain at S = 3 — the owner calls ``update_``,
    ``maintain_`` (firing and not) and ``decay_`` with row flags, their
    functional callables, the routed query and the global top-n (n below
    and above C) — with the dispatch sent to the stand-ins of the CUDA
    wrappers on CPU tensors: a strided or mistyped argument (a receiver's
    slice of the transposed buckets, a column of the stacked top lists)
    fails here, before it reaches the card."""
    monkeypatch.setattr(ops, "_use_ref", lambda impl, x: impl == "ref")
    probe_calls, decay_calls = [], []
    for module, name, stand_in in _kernel_stand_ins(probe_calls, decay_calls):
        monkeypatch.setattr(module, name, stand_in)
    from repro_torch.kernels import topn_merge
    scfg = tsh.ShardedConfig(base=tmc.MCConfig(
        num_rows=32, capacity=8, max_new_per_batch=16, decay_block_rows=block),
        num_shards=3, bucket_factor=1.0)
    gen = torch.Generator().manual_seed(2)
    state = tsh.init_sharded(scfg, device="cpu")
    dirty = torch.zeros((3, 32), dtype=torch.uint8)
    update = tsh.make_update_fn(scfg)
    for _ in range(4):
        batch = torch.randint(-1, 40, (2, 48), generator=gen, dtype=torch.int32)
        src, dst = batch[0], batch[1]         # rows of one tensor
        w = torch.randint(1, 4, (48,), generator=gen, dtype=torch.int32)
        functional = update(state, src, dst, w)
        tsh.update_(state, src, dst, w, scfg=scfg, dirty=dirty)
        for leaf in ("cnt", "order", "tot"):
            assert torch.equal(getattr(state.slabs, leaf),
                               getattr(functional.slabs, leaf))
        for threshold in (0, 2 ** 30):       # fires, and does not
            tsh.maintain_(state, scfg=scfg, total_threshold=threshold,
                          dirty=dirty)
        tsh.make_maintain_fn(scfg, 0)(state)
        tsh.make_decay_fn(scfg)(state)
        tsh.decay_(state, scfg=scfg, dirty=dirty)
        dk, pk, nn, dropped = tsh.query(state, batch[0, ::2], 0.5, 5, scfg=scfg)
        assert dk.shape == (24, 5) and dropped.shape == (3,)
    tsh.update_(state, src, dst, w, scfg=scfg)
    launched = topn_merge.launches
    for n in (3, 12):
        srcs, dsts, probs, lost = tsh.topn(state, n, scfg=scfg)
        assert srcs.shape == dsts.shape == probs.shape == (n,)
        assert bool((probs[1:] <= probs[:-1]).all()) and probs[0] > 0
    assert topn_merge.launches == launched   # the stand-in counts nothing
    assert int(dirty.sum()) > 0 and int(state.route_dropped.sum()) > 0
    assert set(probe_calls) == {(True, 0)}, set(probe_calls)
    assert {rows for rows, _ in decay_calls} == {32}
