"""The port's contract annotations (``repro_torch.analysis.invariants``):
``requires_lock``'s runtime gate, the ``kernel_op`` registration of every
dispatcher of ``kernels/ops.py``, and the lock declarations that
``tools/mcqlint`` checks, which must stay clean over the whole tree."""

import ast
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import invariants as inv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.serve import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:   # tools/ lives at the repo root
    sys.path.insert(0, str(ROOT))

from tools.mcqlint import run_paths  # noqa: E402

#: every dispatcher: (kernel module, its CUDA wrapper, plain version, the
#: reference's TPU kernel it ports or None, composes)
OPS = {
    "oddeven_sort": ("oddeven", "oddeven_cuda", "oddeven_sort_ref",
                     "oddeven_pallas", ()),
    "oddeven_sort_": ("oddeven", "oddeven_cuda_", "oddeven_sort_ref_", None,
                      ()),
    "slab_update": ("slab_update", "slab_update_cuda", "slab_update_ref",
                    "slab_update_pallas", ()),
    "slab_update_": ("slab_update", "slab_update_cuda_", "slab_update_ref_",
                     None, ()),
    "decay_sort": ("decay_sort", "decay_sort_cuda", "decay_sort_ref", None,
                   ()),
    "decay_sort_": ("decay_sort", "decay_sort_cuda_", "decay_sort_ref_",
                    None, ()),
    "decay_sort_rolling": ("decay_sort", "decay_sort_rolling_cuda",
                           "decay_sort_rolling_ref", None, ()),
    "decay_sort_rolling_": ("decay_sort", "decay_sort_rolling_cuda_",
                            "decay_sort_rolling_ref_", None, ()),
    "dh_rebuild_": ("dh_rebuild", "dh_rebuild_cuda_", "dh_rebuild_ref_",
                    None, ()),
    "dh_find": ("probe", "probe_find_cuda", "dh_find_ref",
                "probe_find_pallas", ()),
    "ht_find": ("probe", "probe_find_cuda", "probe_find_ref",
                "probe_find_pallas", ()),
    "cdf_query": ("cdf_query", "cdf_query_cuda", "cdf_query_ref",
                  "cdf_query_pallas", ()),
    "cdf_query_fused": ("cdf_gather", "cdf_query_fused_cuda",
                        "cdf_query_fused_ref", "cdf_query_fused_pallas", ()),
    "topn_merge": ("topn_merge", "topn_merge_cuda", "topn_merge_ref", None,
                   ()),
    "topn_windows": ("topn_windows", "topn_windows_cuda", "topn_windows_ref",
                     None, ()),
    "draft_walk": ("walk", "draft_walk_cuda", "draft_walk_ref",
                   "draft_walk_pallas", ()),
    "slow_path": ("slow_path", "slow_path_cuda", None, None,
                  ("slow_path_",)),
    "slow_path_": ("slow_path", "slow_path_cuda_", "slow_path_ref_", None,
                   ()),
    "copy_dirty_rows": ("copy_rows", "copy_dirty_rows_cuda",
                        "copy_dirty_rows_ref", None, ()),
    "bind_copy_dirty_rows": ("copy_rows", "BoundCatchUp", None, None,
                             ("copy_dirty_rows",)),
    "copy_bound_rows": ("copy_rows", "BoundCatchUp", None, None,
                        ("copy_dirty_rows",)),
}


def _public_defs():
    tree = ast.parse(Path(ops.__file__).read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


def test_every_dispatcher_is_registered_as_the_table_says():
    assert sorted(_public_defs()) == sorted(OPS)
    for name, (_, _, ref, pallas, composes) in OPS.items():
        decl = getattr(getattr(ops, name), inv.KERNEL_OP_ATTR)
        assert decl == {"ref": ref, "pallas": pallas,
                        "composes": composes}, name
        for comp in composes:
            assert hasattr(getattr(ops, comp), inv.KERNEL_OP_ATTR)


@pytest.mark.parametrize("name", sorted(OPS))
def test_registered_op_has_its_cuda_wrapper_and_plain_version(name):
    import importlib
    module, wrapper, ref, pallas, _ = OPS[name]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert callable(getattr(mod, wrapper)), (module, wrapper)
    if ref is not None:
        assert callable(getattr(kref, ref)), ref
    if pallas is not None:   # the reference's TPU kernel this op ports
        src = (ROOT / "src" / "repro" / "kernels").glob("*.py")
        assert any(f"def {pallas}(" in p.read_text() for p in src), pallas


class _Dispatched(Exception):
    pass


@pytest.mark.parametrize("name", sorted(n for n in OPS if OPS[n][2]))
def test_impl_ref_dispatches_to_the_registered_plain_version(name,
                                                             monkeypatch):
    """With ``impl='ref'`` the op calls exactly the plain version its
    registration names (replaced here by a stand-in that stops the call)."""
    ref = OPS[name][2]

    def stand_in(*args, **kw):
        raise _Dispatched(ref)

    monkeypatch.setattr(kref, ref, stand_in)
    fn = getattr(ops, name)
    params = inspect.signature(fn).parameters.values()
    x = torch.zeros((2, 4), dtype=torch.int32)
    args = [x for p in params if p.kind == p.POSITIONAL_OR_KEYWORD
            and p.default is p.empty]
    kw = {p.name: 1 for p in params if p.kind == p.KEYWORD_ONLY
          and p.default is p.empty}
    with pytest.raises(_Dispatched, match=ref):
        fn(*args, impl="ref", **kw)


def test_requires_lock_is_zero_cost_without_the_variable():
    if inv._RUNTIME_CHECKS:
        pytest.skip("MCQ_RUNTIME_LOCK_CHECKS is set in this process")

    def body(self):
        return 1

    assert inv.requires_lock("_lock")(body) is body
    assert getattr(body, inv.REQUIRES_ATTR) == ("_lock",)
    with pytest.raises(ValueError):
        inv.requires_lock()
    with pytest.raises(ValueError):
        inv.kernel_op(pallas="x_pallas")


_RUNTIME_SCRIPT = textwrap.dedent(
    """
    import numpy as np
    from repro_torch.analysis import invariants as inv
    from repro_torch.core import mcprioq as mc, sharded as sh
    from repro_torch.serve.engine import ShardedEngine, ShardedServeConfig
    assert inv._RUNTIME_CHECKS
    eng = ShardedEngine(ShardedServeConfig(sharded=sh.ShardedConfig(
        base=mc.MCConfig(num_rows=16, capacity=4), num_shards=2)),
        device="cpu")
    src = np.arange(4, dtype=np.int32)
    try:
        eng._apply_locked(src, src, np.ones(4, np.int32))
    except AssertionError as exc:
        assert "requires _write_lock held" in str(exc), exc
    else:
        raise SystemExit("unguarded _apply_locked was not caught")
    with eng._write_lock:
        eng._apply_locked(src, src, np.ones(4, np.int32))
    with eng._route_lock:
        eng._rebind(eng.cfg.sharded)
    try:
        eng._rebind(eng.cfg.sharded)
    except AssertionError as exc:
        assert "_route_lock" in str(exc)
    else:
        raise SystemExit("unguarded _rebind was not caught")
    eng.observe(src, src)                      # the real callers hold them
    assert eng.stats["updates"] == 2, eng.stats
    print("LOCK-CHECKS-OK")
    """)


def test_requires_lock_asserts_under_runtime_lock_checks():
    """``MCQ_RUNTIME_LOCK_CHECKS`` is read at import, so the engine runs in
    a subprocess with it set: a ``@requires_lock`` method called without
    its lock raises, with it (and through the engine's own callers) runs."""
    env = dict(os.environ, MCQ_RUNTIME_LOCK_CHECKS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUNTIME_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOCK-CHECKS-OK" in out.stdout


def test_engine_lock_declarations_are_the_references():
    """``_MCQ_LOCK_ORDER`` / ``_MCQ_LOCK_PROTECTS`` are copied verbatim, so
    mcqlint's lock rules check the port's engine as the reference's."""
    def literal(path, name):
        tree = ast.parse(Path(path).read_text())
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "ShardedEngine")
        stmt = next(s for s in cls.body if isinstance(s, ast.Assign)
                    and s.targets[0].id == name)
        return ast.literal_eval(stmt.value)

    ref = ROOT / "src" / "repro" / "serve" / "engine.py"
    for name in (inv.LOCK_ORDER_ATTR, inv.LOCK_PROTECTS_ATTR):
        assert literal(tengine.__file__, name) == literal(ref, name)
    assert inv.declared_locks(tengine.ShardedEngine) == (
        "_write_lock", "_route_lock", "_compile_lock", "_stats_lock")


def test_mcqlint_is_clean_over_the_source_tree():
    findings = run_paths([str(ROOT / "src")])
    assert findings == [], "\n".join(f.render() for f in findings)
