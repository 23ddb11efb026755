"""The sharded global top-n — the port's plain path and the plain mirror of
its CUDA kernels — against the reference's ``make_topn_fn``, bit for bit.

The same seeded numpy states (random slabs, orders and src tables, built
directly rather than by a stream) go through

  * the reference's ``make_topn_fn`` (``impl="ref"``, CPU), whose
    ``shard_map`` needs one fake device per shard: every case runs in ONE
    subprocess with ``--xla_force_host_platform_device_count=40``, one
    trace per case;
  * the port's ``sh.topn`` on the CPU (``topn_lists`` + ``topn_merge``);
  * ``ref.topn_windows_ref``, the decomposition of the CUDA kernels
    (``topn_windows.cu``'s block lists, ``topn_merge.cu``'s merge of
    them), at several block counts, so tiles that do not divide N too.

srcs, dsts, probs and ``dropped`` must be equal.  The CUDA wrappers' limits
and their refusal of CPU tensors are checked without a card.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.core import sharded as tsh
from repro_torch.kernels import ops, ref, topn_windows

from torch_parity import assert_same

ROOT = Path(__file__).resolve().parents[1]
DEVICES = 40

# name: (S, N, C, n, kind)
CASES = {
    "ties": (4, 40, 8, 16, "ties"),          # every live prob equal
    "few_live": (3, 6, 4, 16, "sparse"),     # fewer live window entries than n
    "n_above_c": (4, 30, 8, 12, "random"),   # k = C: whole rows in order
    "n_one": (3, 50, 16, 1, "random"),
    "one_shard": (1, 37, 16, 8, "random"),
    "many_shards": (DEVICES, 10, 4, 16, "random"),
    "approximate_order": (4, 64, 8, 5, "shuffled"),
    "empty": (4, 16, 8, 8, "empty"),
    "stray_lanes": (4, 30, 8, 16, "stray"),  # table lanes past the rows
}
BLOCKS = (1, 2, 3, 7)


def _config(name):
    s, rows, c, _, _ = CASES[name]
    return tsh.ShardedConfig(base=tmc.MCConfig(num_rows=rows, capacity=c,
                                               impl="ref"), num_shards=s)


def _leaves(name):
    """A stacked state's numpy leaves: counts 1-3 (small, so probabilities
    tie often) at some density, an order sorted by count with ties in
    random order (``shuffled``: a random permutation, the order the
    odd-even passes leave behind at worst), totals at or above the row's
    sum, random dsts, and a src table holding about 70 % of the rows
    (``stray``: and, in free lanes, keys whose value is N to N + 2, past
    the rows: no row's src)."""
    s, rows, c, _, kind = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    leaves = convert.sharded_state_to_numpy(
        tsh.init_sharded(_config(name), device="cpu"))
    if kind == "ties":
        cnt = np.full((s, rows, c), 2)
    elif kind == "empty":
        cnt = np.zeros((s, rows, c), np.int64)
    else:
        density = 0.05 if kind == "sparse" else 0.6
        cnt = rng.integers(1, 4, (s, rows, c)) * (rng.random((s, rows, c))
                                                  < density)
    if kind == "shuffled":
        order = np.argsort(rng.random((s, rows, c)), axis=2)
    else:
        order = np.argsort(-cnt - 0.5 * rng.random(cnt.shape), axis=2,
                           kind="stable")
    tot = cnt.sum(axis=2)
    if kind not in ("ties", "empty"):
        tot = tot + rng.integers(0, 3, (s, rows))
    table = leaves["src_table.keys"].shape[1]
    keys = np.full((s, table), -1)
    vals = np.full((s, table), -1)
    for i in range(s):
        rows_held = np.flatnonzero(rng.random(rows) < 0.7)
        at = rng.choice(table, rows_held.size, replace=False)
        keys[i, at] = rng.choice(10 ** 6, rows_held.size, replace=False)
        vals[i, at] = rows_held
        if kind == "stray":
            free = np.setdiff1d(np.arange(table), at)[:rows // 2]
            keys[i, free] = 10 ** 6 + np.arange(free.size)
            vals[i, free] = rows + rng.integers(0, 3, free.size)
    leaves.update({"slabs.cnt": cnt, "slabs.order": order, "slabs.tot": tot,
                   "slabs.dst": rng.integers(0, 5000, (s, rows, c)),
                   "src_table.keys": keys, "src_table.vals": vals})
    return {k: np.ascontiguousarray(v, dtype=np.int32) for k, v in leaves.items()}


SCRIPT = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(devices)d"
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.core import mcprioq as mc, sharded as sh

    inputs, out_dir = np.load(sys.argv[1]), sys.argv[2]
    cases = json.loads(sys.argv[3])
    rec = {}
    for name, (s, rows, c, n, _) in cases.items():
        scfg = sh.ShardedConfig(base=mc.MCConfig(num_rows=rows, capacity=c,
                                                 impl="ref"), num_shards=s)
        mesh = compat.make_mesh((s,), ("shard",), devices=jax.devices()[:s])
        template = sh.init_sharded(scfg, mesh)
        state = mc.MCState(*(
            type(field)(*(jnp.asarray(inputs[f"{name}/{key}.{sub}"])
                          for sub in field._fields))
            if hasattr(field, "_fields") else jnp.asarray(inputs[f"{name}/{key}"])
            for key, field in zip(mc.MCState._fields, template)))
        out = sh.make_topn_fn(scfg, mesh, n)(state)
        rec.update({f"{name}/{k}": np.asarray(v) for k, v in
                    zip(("srcs", "dsts", "probs", "dropped"), out)})
    np.savez(os.path.join(out_dir, "topn.npz"), **rec)
    print("JAX-TOPN-OK")
    """ % dict(devices=DEVICES))


@pytest.fixture(scope="module")
def jax_topn(tmp_path_factory):
    """Every case's top-n through the reference, in one subprocess."""
    tmp = tmp_path_factory.mktemp("topn")
    np.savez(tmp / "inputs.npz", **{f"{name}/{k}": v for name in CASES
                                    for k, v in _leaves(name).items()})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "inputs.npz"), str(tmp),
         json.dumps(CASES)], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-TOPN-OK" in out.stdout
    rec = np.load(tmp / "topn.npz")
    return {name: {k: rec[f"{name}/{k}"] for k in ("srcs", "dsts", "probs",
                                                   "dropped")}
            for name in CASES}


def _state(name):
    return convert.sharded_state_from_numpy(_leaves(name), _config(name),
                                            device="cpu")


def _mirror(state, n, blocks):
    slabs = state.slabs
    return ref.topn_windows_ref(slabs.cnt, slabs.order, slabs.tot, slabs.dst,
                                *state.src_table, n, blocks)


def _named(out):
    return dict(zip(("srcs", "dsts", "probs", "dropped"), out))


@pytest.mark.parametrize("name", list(CASES))
def test_port_topn_equals_the_reference(name, jax_topn):
    """The port's plain path (``topn_lists`` + ``topn_merge``) == the
    reference's ``make_topn_fn``; the answer is not trivial where it
    should not be."""
    want = jax_topn[name]
    n = CASES[name][3]
    got = tsh.topn(_state(name), n, scfg=_config(name))
    assert_same(want, _named(got), f"{name}: sh.topn")
    live = int((want["probs"] > 0).sum())
    if name == "empty":
        assert live == 0 and int(want["dropped"]) == 0
    else:
        assert live > 0
    if name == "few_live":
        assert live < n
    if name == "ties":
        assert np.unique(want["probs"]).size == 1 and live == n


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_decomposition_equals_the_reference(name, blocks, jax_topn):
    """The CUDA kernels' plain mirror — block lists of row tiles, then the
    two-level merge of them with its labels — == the reference at every
    block count (tiles of ceil(N / blocks) rows, the last one short)."""
    n = CASES[name][3]
    got = _mirror(_state(name), n, blocks)
    assert_same(jax_topn[name], _named(got), f"{name}: mirror, {blocks} blocks")


@pytest.mark.parametrize("name", ["ties", "n_above_c", "many_shards"])
def test_ops_topn_windows_dispatches_the_mirror_on_the_cpu(name, jax_topn):
    state = _state(name)
    slabs = state.slabs
    got = ops.topn_windows(slabs.cnt, slabs.order, slabs.tot, slabs.dst,
                           *state.src_table, n=CASES[name][3])
    assert_same(jax_topn[name], _named(got), f"{name}: ops.topn_windows")


def test_window_lists_are_each_tiles_best_keys():
    """The kernel's lists and counts by their definition: list s·B + b
    holds tile b's live keys, largest first, 0-padded; the counts are the
    live edges and live window entries of each shard."""
    name = "n_above_c"
    s, rows, c, n, _ = CASES[name]
    state = _state(name)
    slabs = state.slabs
    lists, counts = ref.topn_window_lists_ref(slabs.cnt, slabs.order,
                                              slabs.tot, n, 3)
    assert lists.shape == (s * 3, n) and counts.shape == (s, 2)
    k = min(n, c)
    tile = -(-rows // 3)
    for i in range(s):
        cnt_k = torch.gather(slabs.cnt[i], 1, slabs.order[i, :, :k].long())
        assert int(counts[i, 0]) == int((slabs.cnt[i] > 0).sum())
        assert int(counts[i, 1]) == int((cnt_k > 0).sum())
        for b in range(3):
            keys = []
            for row in range(b * tile, min(rows, (b + 1) * tile)):
                for j in range(k):
                    cv = int(cnt_k[row, j])
                    if cv > 0:
                        p = torch.tensor(cv, dtype=torch.float32) / torch.tensor(
                            max(int(slabs.tot[i, row]), 1), dtype=torch.float32)
                        bits = int(p.view(torch.int32))
                        keys.append((bits << 32) | (0xFFFFFFFF - (row * k + j)))
            keys = sorted(keys, reverse=True)[:n]
            want = keys + [0] * (n - len(keys))
            assert lists[i * 3 + b].tolist() == want, (i, b)


def test_merge_launches_mirror_the_flat_merge_at_any_list_count():
    """``topn_merge_rounds_ref`` (one launch of up to 1,024 lists for n <=
    256, fewer above, in two levels) == the flat ``topn_merge_ref`` on lists
    that are not descending, with NaN, -0.0 and negative heads, at list
    counts that take one and two launches."""
    rng = np.random.default_rng(7)
    for lists, m, n in ((33, 5, 16), (64, 3, 40), (1100, 2, 9), (40, 4, 300)):
        probs = torch.from_numpy(rng.integers(0, 6, (lists, m))
                                 .astype(np.float32) / 8)
        probs[torch.from_numpy(rng.random((lists, m)) < 0.1)] = float("nan")
        probs[torch.from_numpy(rng.random((lists, m)) < 0.1)] = -0.0
        probs[torch.from_numpy(rng.random((lists, m)) < 0.05)] = -0.5
        dsts = torch.from_numpy(rng.integers(0, 500, (lists, m)).astype(np.int32))
        srcs = torch.from_numpy(rng.integers(0, 500, (lists, m)).astype(np.int32))
        want = ref.topn_merge_ref(probs, dsts, srcs, n)
        got = ref.topn_merge_rounds_ref(probs, dsts, srcs, n)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (lists, m, n)
    assert ref.merge_lists_per_launch(16) == 1024
    assert ref.merge_lists_per_launch(256) == 1024
    assert ref.merge_lists_per_launch(1024) == 256
    assert ref.merge_lists_per_launch(9000) == 32


def test_impl_cuda_on_cpu_tensors_raises():
    name = "ties"
    state = _state(name)
    scfg = _config(name)
    cuda = tsh.ShardedConfig(base=tmc.MCConfig(num_rows=scfg.base.num_rows,
                                               capacity=scfg.base.capacity,
                                               impl="cuda"), num_shards=4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsh.topn(state, 8, scfg=cuda)
    slabs = state.slabs
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.topn_windows(slabs.cnt, slabs.order, slabs.tot, slabs.dst,
                         *state.src_table, n=8, impl="cuda")
    before = topn_windows.launches
    with pytest.raises(ValueError, match="takes CUDA"):
        topn_windows.topn_windows_cuda(slabs.cnt, slabs.order, slabs.tot,
                                       slabs.dst, *state.src_table, n=8)
    assert topn_windows.launches == before


@pytest.mark.parametrize("shape,n,limit", [
    ((2, 600, 4), 1025, "MAX_N"),
    ((2, 4, 1030), 4, "MAX_CAPACITY"),
    ((300, 8, 1024), 1024, "lists one merge block takes"),
    ((2, 4, 4), 17, "top-n of 17 over 16 entries per shard"),
    ((2 ** 10, 2 ** 21, 4), 4, "a winner's flat row"),
])
def test_cuda_path_names_the_limit_it_refuses(shape, n, limit):
    """Shapes the CUDA path does not take raise before any launch, with
    the limit named (checked before the device, so on CPU tensors too);
    meta tensors keep the large shapes free."""
    s, rows, c = shape
    x = torch.empty(shape, dtype=torch.int32, device="meta")
    v = torch.empty((s, rows), dtype=torch.int32, device="meta")
    table = torch.empty((s, 4 * rows), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=limit):
        topn_windows.topn_windows_cuda(x, x, v, x, table, table, n=n)
    with pytest.raises(ValueError, match=limit):
        topn_windows.window_lists_cuda(x, x, v, n=n)


def test_n_above_the_windows_raises_on_the_plain_path_too():
    state = _state("one_shard")
    with pytest.raises(ValueError, match="top-n of 600 over 592 entries"):
        tsh.topn(state, 600, scfg=_config("one_shard"))


def test_src_of_row_is_the_tables_scatter():
    """``ref.src_of_row_ref`` (what the label pass reads for the winners):
    each valid lane's key at its row, EMPTY elsewhere, contiguous."""
    state = _state("n_above_c")
    keys, vals = (x.numpy() for x in state.src_table)
    s, rows = state.slabs.tot.shape
    got = ref.src_of_row_ref(*state.src_table, rows)
    want = np.full((s, rows), -1)
    for i in range(s):
        ok = (keys[i] >= 0) & (vals[i] >= 0)
        want[i, vals[i][ok]] = keys[i][ok]
    assert got.is_contiguous() and got.tolist() == want.tolist()


def test_src_of_row_drops_lanes_past_the_rows_as_the_reference_does():
    """A valid lane whose value is at or past N names no row: the
    reference's ``.at[idx].set(mode="drop")`` drops it, and so does
    ``ref.src_of_row_ref`` (the plain path's ``sh._src_of_row`` and the
    mirror of the label pass), shard by shard."""
    import types

    import jax.numpy as jnp
    from repro.core import sharded as jsh
    state = _state("stray_lanes")
    keys, vals = state.src_table
    s, rows = state.slabs.tot.shape
    assert int((vals >= rows).sum()) > 0 and int((vals == rows).sum()) > 0
    got = ref.src_of_row_ref(keys, vals, rows)
    for i in range(s):
        table = types.SimpleNamespace(keys=jnp.asarray(keys[i].numpy()),
                                      vals=jnp.asarray(vals[i].numpy()))
        want = jsh._src_of_row(types.SimpleNamespace(src_table=table), rows)
        assert got[i].tolist() == np.asarray(want).tolist(), i
    assert torch.equal(tsh._src_of_row(state, rows), got)


def test_topn_ablation_script_runs_on_the_card_only():
    """``scripts/topn_ablation.py`` imports nothing of the reference and
    exits non-zero without a GPU."""
    import ast
    import importlib.util
    path = ROOT / "scripts" / "topn_ablation.py"
    imported = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert not imported & {"jax", "jaxlib", "repro", "tools"}
    spec = importlib.util.spec_from_file_location("topn_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not torch.cuda.is_available():
        assert mod.main([]) == 2
