"""The N -> M reshard composition on the port against the reference's,
tolerance 0.

The composition is the reference engine's ``_reingest``
(``src/repro/serve/engine.py:1367-1394``): ``extract_edges`` -> ``owner_of``
under the new map -> ``plan_batches`` -> the routed update with the
new-edge bound lifted (``max_new_per_batch=0``) -> ``settle_order``.  The
reference needs one (fake) device per shard, so its side runs in ONE
subprocess for the whole file (``--xla_force_host_platform_device_count=8``,
as ``tests/test_torch_sharded.py`` runs it): it learns a 4-shard state from a
seeded stream, reshards it onto 2 and onto 8 shards, and writes every array
of every step to an ``.npz``.  The port starts from the same 4-shard state
(and, separately, learns it itself) and must give the same edges, owners,
batches, and every stacked leaf after the ingest and after the settle.
"""

import dataclasses
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
from repro_torch.core import slab as tsl
from repro_torch.persist import reshard as rs

from torch_parity import assert_same

ROOT = Path(__file__).resolve().parents[1]
OLD = dict(num_rows=256, capacity=32, sort_passes=1, max_new_per_batch=48,
           decay_block_rows=16)
NEW = dict(num_rows=256, capacity=32, sort_passes=1, max_new_per_batch=48,
           decay_block_rows=16)
N, TARGETS, SLICE, BATCHES, PER_SENDER = 4, (2, 8), 16, 6, 64


def _stream():
    """The old chain's seeded batches: hot srcs, a few negative dsts."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(BATCHES):
        size = PER_SENDER * N
        hot = rng.random(size) < 0.4
        src = np.where(hot, rng.integers(0, 12, size), rng.integers(0, 400, size))
        dst = rng.integers(0, 60, size)
        dst[rng.random(size) < 0.03] = -5
        out.append((src.astype(np.int32), dst.astype(np.int32),
                    rng.integers(1, 4, size).astype(np.int32)))
    return out


SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.core import mcprioq as mc, sharded as sh
    from repro.persist import reshard as rs

    inputs, out_path = np.load(sys.argv[1]), sys.argv[2]
    old, new = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    n, targets, slice_len = json.loads(sys.argv[5])

    def leaves(state, prefix):
        out = {}
        for field, leaf in zip(state._fields, state):
            if hasattr(leaf, "_fields"):
                for sub, x in zip(leaf._fields, leaf):
                    out[f"{prefix}/{field}.{sub}"] = np.asarray(x)
            else:
                out[f"{prefix}/{field}"] = np.asarray(leaf)
        return out

    def mesh(s):
        return compat.make_mesh((s,), ("shard",), devices=jax.devices()[:s])

    scfg = sh.ShardedConfig(base=mc.MCConfig(**old), num_shards=n,
                            bucket_factor=4.0)
    update = sh.make_update_fn(scfg, mesh(n))
    state = sh.init_sharded(scfg, mesh(n))
    for b in range(len([k for k in inputs.files if k.startswith("src")])):
        state = update(state, *(jnp.asarray(inputs[f"{k}{b}"])
                                for k in ("src", "dst", "w")))
    state = sh.make_maintain_fn(scfg, mesh(n), 40)(state)
    rec = leaves(state, "old")
    for m in targets:
        new_scfg = sh.ShardedConfig(base=mc.MCConfig(**new), num_shards=m,
                                    bucket_factor=2.0)
        # engine.py:1367-1394, with the slice length given
        src, dst, cnt = rs.extract_edges(state)
        owner = np.asarray(new_scfg.resolved_ownership().owner_of(
            jnp.asarray(src)))
        sl = max(m, slice_len)
        cap = new_scfg.bucket_capacity(sl)
        ingest_scfg = dataclasses.replace(new_scfg, base=dataclasses.replace(
            new_scfg.base, max_new_per_batch=0))
        ingest = sh.make_update_fn(ingest_scfg, mesh(m))
        fresh = sh.init_sharded(new_scfg, mesh(m))
        batches = list(rs.plan_batches(src, dst, cnt, owner, m, sl, cap))
        for bsrc, bdst, bw in batches:
            fresh = ingest(fresh, jnp.asarray(bsrc), jnp.asarray(bdst),
                           jnp.asarray(bw))
        rec.update(leaves(fresh, f"M{m}/ingested"))
        rec.update(leaves(rs.settle_order(fresh), f"M{m}/settled"))
        rec.update({f"M{m}/edges/src": src, f"M{m}/edges/dst": dst,
                    f"M{m}/edges/cnt": cnt, f"M{m}/owner": owner,
                    f"M{m}/batches": np.stack([np.stack(b) for b in batches])})
    np.savez(out_path, **rec)
    print("JAX-RESHARD-OK")
    """)


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    np.savez(tmp / "inputs.npz", **{f"{k}{b}": v for b, batch in
                                    enumerate(_stream())
                                    for k, v in zip(("src", "dst", "w"), batch)})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "out.npz"), json.dumps(OLD), json.dumps(NEW),
         json.dumps([N, list(TARGETS), SLICE])],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-RESHARD-OK" in out.stdout
    return dict(np.load(tmp / "out.npz"))


def _leaves(rec, prefix):
    return {name: rec[f"{prefix}/{name}"] for name in convert.LEAF_NAMES}


def _scfg(spec, shards, factor):
    return tsh.ShardedConfig(base=tmc.MCConfig(**spec), num_shards=shards,
                             bucket_factor=factor)


def test_the_port_learns_the_same_old_state(jax_records):
    scfg = _scfg(OLD, N, 4.0)
    state = tsh.init_sharded(scfg, device="cpu")
    for src, dst, w in _stream():
        tsh.update_(state, src, dst, w, scfg=scfg)
    tsh.maintain_(state, scfg=scfg, total_threshold=40)
    assert_same(_leaves(jax_records, "old"),
                convert.sharded_state_to_numpy(state), "the 4-shard state")
    stats = tmc.counter_stats(state)
    assert stats["n_rows"] > 300 and stats["deferred_new"] > 0, stats


@pytest.mark.parametrize("m", TARGETS)
def test_reshard_composition_equals_the_references(jax_records, m):
    """4 -> M: the extracted edges, their owners under M's default map, every
    planned batch, every stacked leaf after the ingest (the routed update
    with ``max_new_per_batch=0``, through the owner calls) and after
    ``settle_order_``, equal to the reference's; nothing dropped; counts,
    row totals and the edge multiset conserved."""
    old = convert.sharded_state_from_numpy(_leaves(jax_records, "old"),
                                           _scfg(OLD, N, 4.0), device="cpu")
    scfg = _scfg(NEW, m, 2.0)
    src, dst, cnt = rs.extract_edges(old)
    for name, got in (("src", src), ("dst", dst), ("cnt", cnt)):
        want = jax_records[f"M{m}/edges/{name}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    owner = scfg.resolved_ownership().owner_of(torch.from_numpy(src)).numpy()
    assert np.array_equal(owner, jax_records[f"M{m}/owner"])
    slice_len = max(m, SLICE)
    ingest = dataclasses.replace(scfg, base=dataclasses.replace(
        scfg.base, max_new_per_batch=0))
    new = tsh.init_sharded(scfg, device="cpu")
    batches = list(rs.plan_batches(src, dst, cnt, owner, m, slice_len,
                                   scfg.bucket_capacity(slice_len)))
    assert np.array_equal(np.stack([np.stack(b) for b in batches]),
                          jax_records[f"M{m}/batches"])
    for b in batches:
        tsh.update_(new, *b, scfg=ingest)
    assert_same(_leaves(jax_records, f"M{m}/ingested"),
                convert.sharded_state_to_numpy(new), f"4 -> {m}: ingested")
    assert rs.settle_order_(new) is new
    assert_same(_leaves(jax_records, f"M{m}/settled"),
                convert.sharded_state_to_numpy(new), f"4 -> {m}: settled")

    stats = tmc.counter_stats(new)
    assert stats["route_dropped"] == stats["deferred_new"] == 0, stats
    assert stats["dropped_rows"] == stats["evictions"] == 0, stats
    got = rs.extract_edges(new)
    assert src.size == got[0].size + stats["dropped_probes"]
    if stats["dropped_probes"] == 0:
        assert sorted(zip(*got)) == sorted(zip(src, dst, cnt))
    old_tot, new_tot = {}, {}
    for tot, edges in ((old_tot, (src, cnt)), (new_tot, (got[0], got[2]))):
        for s, c in zip(*edges):
            tot[int(s)] = tot.get(int(s), 0) + int(c)
    assert all(old_tot[s] == t for s, t in new_tot.items())
    for r in range(m):
        one = tsh.shard_state(new, r)
        assert int(tsl.inversions(one.slabs.cnt, one.slabs.order).sum()) == 0
        inv = tmc.check_invariants(one, scfg.base)
        assert all(v for k, v in inv.items() if k != "sorted_fraction"), inv
