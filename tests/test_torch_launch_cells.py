"""The port's cell grid, H100 roofline and meta-device dry run
(``repro_torch.launch.{cells,roofline,dryrun}``) against the reference's
``repro.launch.{cells,roofline,hlo_cost}``.

* Every (arch, shape) of the 10 x 4 grid: the same ``cell_of`` (``None``
  for ``long_500k`` on full attention), the same ``batch_specs`` keys,
  shapes and dtypes (meta tensors against ``ShapeDtypeStruct``s), and
  ``model_flops`` / ``memory_floor_bytes`` equal to the bit (a skipped
  cell's on the cell the reference would build).
* ``decode_specs``' caches on the smoke configs against the reference's
  ``jax.eval_shape``, leaf for leaf, under two stated differences and no
  other (ROADMAP queue C): the port keeps one cache tree per period in a
  list where the reference stacks the periods on a leading axis (C 26),
  and a ``local_attn`` ring holds ``local_window + STEP_ROWS`` positions
  (C 30).  The reference's ``ring`` flag is a bool array, the port's a
  Python bool of the same value.
* The port's ``FlopCounterMode`` count of a smoke prefill against the
  reference's ``hlo_cost.analyze`` FLOPs of the same compiled prefill on
  the CPU.  Both count 2·M·N·K per matmul and nothing else, so they are
  equal (tolerance 0) where the two prefills do the same matmuls: dense
  ``qwen2-7b``.  ``recurrentgemma-9b``'s differ by a sum known in closed
  form, C 30 again: the port's ``local_attn`` prefill attends over the whole
  prompt, the reference's over its ring of ``local_window`` slots, so the
  port counts ``4·b·h·s·(s - window)·hd`` more FLOPs per local layer
  (scores and values), exactly.
* ``python -m repro_torch.launch.dryrun`` for one cell writes a JSON with
  every field; ``--multi-pod`` is refused by name.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as RARCHS
from repro.configs import smoke_config as rsmoke
from repro.launch import cells as rcells
from repro.launch import hlo_cost
from repro.launch import roofline as rroof
from repro.models import Model as RModel
from repro_torch.checkpoint.ckpt import _paths_and_leaves
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch import cells, dryrun, roofline
from repro_torch.models.model import STEP_ROWS, Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = [(arch, shape) for arch in sorted(RARCHS) for shape in rcells.SHAPES]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _torch_dtype(jdtype):
    return {jnp.int32: torch.int32, jnp.float32: torch.float32,
            jnp.bfloat16: torch.bfloat16, jnp.bool_: torch.bool}[
                jnp.dtype(jdtype).type]


def test_the_grid_is_the_references():
    assert sorted(ARCHS) == sorted(RARCHS)
    assert cells.SHAPES == rcells.SHAPES
    assert cells.SUBQUADRATIC == rcells.SUBQUADRATIC
    assert [(a, s) for a, s, _ in cells.all_cells()] == GRID
    skipped = 0
    for arch, shape, cell in cells.all_cells():
        want = rcells.cell_of(arch, shape)
        if want is None:
            assert cell is None
            skipped += 1
            continue
        assert dataclasses.asdict(cell) == dataclasses.asdict(want)
        assert cell.name == want.name == f"{arch}/{shape}"
    assert len(GRID) == 40 and skipped == 8


def _as_cell(arch, shape):
    """The cell, or for a skipped one the cell the reference would build."""
    return (rcells.cell_of(arch, shape)
            or rcells.Cell(arch, shape, "decode", 1, 524288))


@pytest.mark.parametrize("arch,shape", GRID)
def test_batch_specs_and_the_roofline_formulas(arch, shape):
    rcfg, cfg = RARCHS[arch], get_config(arch)
    rc = _as_cell(arch, shape)
    cell = cells.Cell(**dataclasses.asdict(rc))
    for n in (1, 512):
        assert (roofline.model_flops(cfg, cell, n)
                == rroof.model_flops(rcfg, rc, n))
        assert (roofline.memory_floor_bytes(cfg, cell, n)
                == rroof.memory_floor_bytes(rcfg, rc, n))
    if rcells.cell_of(arch, shape) is None or rc.kind == "decode":
        return
    want = rcells.batch_specs(rcfg, rc)
    got = cells.batch_specs(cfg, cell)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == want[k].shape
        assert v.dtype == _torch_dtype(want[k].dtype)


def _port_key(path, period=None):
    """The port's key (``ckpt._paths_and_leaves``' spelling) of a reference
    cache leaf; under ``stack`` the period's list index comes first."""
    parts = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            parts.append(str(p.key))
            if p.key == "stack":
                parts.append(str(period))
        elif isinstance(p, jax.tree_util.SequenceKey):
            parts.append(str(p.idx))
        else:
            parts.append(f".{p.name}")
    return "/".join(parts)


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a, s in GRID
    if s in ("decode_32k", "long_500k") and rcells.cell_of(a, s)])
def test_decode_specs_are_the_references_caches(arch, shape):
    rcfg, cfg = rsmoke(arch), smoke_config(arch)
    rc = rcells.cell_of(arch, shape)
    rcaches, rtok, rpos = rcells.decode_specs(rcfg, rc)
    caches, tok, pos = cells.decode_specs(cfg, cells.cell_of(arch, shape))
    assert tuple(tok.shape) == rtok.shape and tok.dtype == torch.int32
    assert tuple(pos.shape) == rpos.shape and pos.dtype == torch.int32
    keys, leaves, _ = _paths_and_leaves(caches)
    got = dict(zip(keys, leaves))
    periods = rcfg.num_periods()
    mapped = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(rcaches)[0]:
        stacked = any(isinstance(p, jax.tree_util.DictKey)
                      and p.key == "stack" for p in path)
        shape_ = leaf.shape[1:] if stacked else leaf.shape
        if stacked:
            assert leaf.shape[0] == periods          # C 26: one list entry
        for period in (range(periods) if stacked else [None]):
            key = _port_key(path, period)
            mine = got[key]
            mapped.add(key)
            if key.endswith("/.ring"):   # a bool array there, a bool here
                assert shape_ == () and isinstance(mine, bool)
                continue
            want = list(shape_)
            if got.get(key.rsplit("/", 1)[0] + "/.ring"):
                want[1] = min(rcfg.local_window + STEP_ROWS, rc.seq)  # C 30
            assert mine.device.type == "meta"
            assert list(mine.shape) == want, key
            assert mine.dtype == _torch_dtype(leaf.dtype), key
    assert mapped == set(keys)
    rings = [k for k in keys if k.endswith("/.ring")]
    assert any(got[k] for k in rings) == ("local_attn" in rcfg._all_kinds())


def _reference_prefill_flops(arch, b, s):
    model = RModel(rsmoke(arch))
    params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    compiled = jax.jit(lambda p, x: model.prefill(p, x, s)).lower(
        params, batch).compile()
    return hlo_cost.analyze(compiled.as_text()).flops


def _port_prefill_flops(arch, b, s):
    from torch.utils.flop_counter import FlopCounterMode
    model = Model(smoke_config(arch))
    params = model.abstract_params()
    with FlopCounterMode(display=False) as fc:
        model.prefill(params, {"tokens": torch.empty(
            (b, s), dtype=torch.int32, device="meta")}, s)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-9b"])
def test_counted_prefill_flops_are_the_hlo_counts(arch):
    b, s = 2, 64
    cfg = smoke_config(arch)
    want = _reference_prefill_flops(arch, b, s)
    local = sum(k == "local_attn" for k in cfg._all_kinds())
    excess = (local * 4 * b * cfg.num_heads * s
              * max(s - cfg.local_window, 0) * cfg.head_dim)
    assert (arch == "recurrentgemma-9b") == (excess > 0)
    assert _port_prefill_flops(arch, b, s) == want + excess


def test_the_roofline_terms():
    cfg = get_config("qwen2-7b")
    cell = cells.cell_of("qwen2-7b", "decode_32k")
    roof = roofline.analyse(2e12, 3.35e12, cfg, cell, measured_s=4.0)
    d = roof.to_dict()
    assert d["t_memory_s"] == 1.0 and d["t_collective_s"] == 0.0
    assert d["bottleneck"] == "memory" and d["measured_share"] == 0.25
    assert d["t_compute_s"] == 2e12 / 989e12
    assert d["model_flops_per_device"] == roofline.model_flops(cfg, cell)
    assert roofline.analyse(1.0, 1.0, cfg, cell).measured_share is None
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)


def test_the_dry_run_writes_one_cell(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "1 cells, 0 failed" in out.stdout
    (path,) = tmp_path.iterdir()
    res = json.loads(path.read_text())
    cfg, cell = get_config("mamba2-130m"), cells.cell_of("mamba2-130m",
                                                         "decode_32k")
    assert res["status"] == "ok" and res["device"] == "meta"
    assert set(res["bytes"]) == {"params", "caches", "batch", "total"}
    assert res["bytes"]["total"] == sum(
        v for k, v in res["bytes"].items() if k != "total")
    assert res["bytes"]["params"] == 4 * sum(
        x.numel() for x in _paths_and_leaves(
            Model(cfg).abstract_params())[1])
    assert res["fits_one_card"] is True and res["card_bytes"] == 80 * 2 ** 30
    assert "activations" in res["fits_note"]
    assert res["model_flops"] == roofline.model_flops(cfg, cell)
    assert res["memory_floor_bytes"] == roofline.memory_floor_bytes(cfg, cell)
    assert res["rows_per_sequence"] == STEP_ROWS
    assert res["counted_flops"] > res["model_flops"]   # 8 rows a sequence
    assert res["eager_bytes"] > res["bytes"]["params"] / 2
    assert set(res["roofline"]) == set(roofline.analyse(
        1.0, 1.0, cfg, cell).to_dict())
    assert res["roofline"]["flops_per_device"] == res["counted_flops"]
    assert res["roofline"]["hbm_bytes_per_device"] == res["eager_bytes"]


def test_skipped_cells_and_a_multi_pod_are_said_by_name(capsys):
    res = dryrun.count_cell("qwen2-7b", "long_500k")
    assert res["status"] == "skipped" and "500k" in res["reason"]
    with pytest.raises(SystemExit, match="--multi-pod: .* one card"):
        dryrun.main(["--all", "--multi-pod"])
    with pytest.raises(SystemExit):
        dryrun.main([])
    assert np.isfinite(dryrun.CARD_BYTES)


def test_a_cell_that_reads_a_value_on_the_host_is_recorded(monkeypatch):
    """whisper's decode checks its position against the self-cache on the
    host (``Model.extend_step``): on meta tensors the count stops there,
    and the cell keeps its bytes and says why it has no count."""
    def host_read(model, cell, cfg):
        parts = {"params": {"w": torch.empty((4, 8), device="meta")}}

        def call():
            int(torch.empty((), device="meta"))
        return parts, call

    monkeypatch.setattr(dryrun, "_run", host_read)
    res = dryrun.count_cell("mamba2-130m", "decode_32k")
    assert res["status"] == "not_counted" and "host" in res["reason"]
    assert res["bytes"] == {"params": 128, "total": 128}
    assert "counted_flops" not in res

    def fails(model, cell, cfg):
        def call():
            raise RuntimeError("a shape mismatch")
        return {}, call

    monkeypatch.setattr(dryrun, "_run", fails)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        dryrun.count_cell("mamba2-130m", "decode_32k")
