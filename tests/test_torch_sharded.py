"""The sharded chain on one device (``repro_torch.core.sharded``) against the
reference's ``shard_map`` path, tolerance 0.

The reference needs one (fake) device per shard, and the device count is
fixed when jax starts, so its side runs in ONE subprocess for the whole file
(``--xla_force_host_platform_device_count=8``, as ``tests/test_sharded.py``
runs it): a module-scoped fixture hands it the numpy inputs of every
scenario, and it writes every stacked leaf and every output after every
call to an ``.npz``.  The port replays the same inputs on the CPU through
its owner calls and compares after each call: the 18 stacked leaves,
``route_dropped`` among them, the answers, ``n_needed``, the query drop
vector and the top-n ``srcs/dsts/probs/dropped``.
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

import jax
import jax.numpy as jnp

from repro import compat
from repro.core import mcprioq as jmc
from repro.core import sharded as jsh
from repro.sharding.ownership import Ownership as JOwnership
from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.core import sharded as tsh
from repro_torch.core.hashtable import EMPTY
from repro_torch.kernels import ops as tops
from repro_torch.sharding import Ownership

from test_torch_owner import no_clone_or_host_read
from torch_parity import assert_same

ROOT = Path(__file__).resolve().parents[1]
STW = dict(num_rows=256, capacity=32, sort_passes=4)
ROLLING = dict(num_rows=256, capacity=32, sort_passes=1, decay_block_rows=16)
PER_SENDER, QUERIES_PER_SENDER, BATCHES, THRESHOLD = 48, 16, 5, 12


def _reassigned(num_shards=4):
    """A non-default map: every third bucket moved, shard 0 made hot."""
    own = Ownership(num_shards=num_shards)
    for b in range(0, own.num_buckets, 3):
        own = own.reassign(b, 0 if b % 2 else (b * 7) % num_shards)
    return own.assignment


SCENARIOS = {
    **{f"s{s}_{kind}": dict(shards=s, base=base, factor=4.0)
       for kind, base in (("stw", STW), ("rolling", ROLLING))
       for s in (1, 2, 4, 8)},
    "s3_rolling": dict(shards=3, base=ROLLING, factor=4.0),
    "s4_drops": dict(shards=4, base=ROLLING, factor=0.5, skew=0.8),
    "s4_reassigned": dict(shards=4, base=STW, factor=2.0,
                          assignment=_reassigned()),
}


def _plan():
    """The calls of every scenario, in order."""
    ops = []
    for b in range(BATCHES):
        ops += [("update", b), ("maintain", b), ("query", b)]
        if b % 2:
            ops.append(("decay", b))
        if b in (2, BATCHES - 1):
            ops += [("topn", 8), ("topn", 40)]
    return ops


PLAN = _plan()


def _inputs(name):
    """Seeded numpy batches of one scenario: skewed srcs (hot nodes take
    half of a batch, more with ``skew``), a few negative dsts, weights 1-3,
    padding (-1) at a batch's tail and scattered, unknown query srcs."""
    spec = SCENARIOS[name]
    s = spec["shards"]
    rng = np.random.default_rng(sum(map(ord, name)))
    out = {}
    for b in range(BATCHES):
        size = PER_SENDER * s
        hot = rng.random(size) < spec.get("skew", 0.5)
        src = np.where(hot, rng.integers(0, 8, size), rng.integers(0, 90, size))
        if b == 1:
            src[-7:] = -1
        if b == 3:
            src[rng.random(size) < 0.1] = -1
        dst = rng.integers(0, 40, size)
        dst[rng.random(size) < 0.03] = -5
        q = rng.integers(0, 100, QUERIES_PER_SENDER * s)
        q[-3:] = -1
        out.update({f"src{b}": src, f"dst{b}": dst, f"q{b}": q,
                    f"w{b}": rng.integers(1, 4, size)})
    return {k: v.astype(np.int32) for k, v in out.items()}


SCRIPT = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from concurrent.futures import ThreadPoolExecutor
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.core import mcprioq as mc, sharded as sh
    from repro.sharding.ownership import Ownership

    inputs, out_dir = np.load(sys.argv[1]), sys.argv[2]
    scenarios, plan = json.loads(sys.argv[3]), json.loads(sys.argv[4])

    def leaves(state):
        out = {}
        for field, leaf in zip(state._fields, state):
            if hasattr(leaf, "_fields"):
                for sub, x in zip(leaf._fields, leaf):
                    out[f"{field}.{sub}"] = np.asarray(x)
            else:
                out[field] = np.asarray(leaf)
        return out

    def run(item):
        name, spec = item
        s = spec["shards"]
        own = (Ownership(num_shards=s, assignment=tuple(spec["assignment"]))
               if spec.get("assignment") else None)
        scfg = sh.ShardedConfig(base=mc.MCConfig(**spec["base"]), num_shards=s,
                                bucket_factor=spec["factor"], ownership=own)
        mesh = compat.make_mesh((s,), ("shard",), devices=jax.devices()[:s])
        fns = {"update": sh.make_update_fn(scfg, mesh),
               "query": sh.make_query_fn(scfg, mesh, 0.9, 8),
               "maintain": sh.make_maintain_fn(scfg, mesh, %(threshold)d),
               "decay": sh.make_decay_fn(scfg, mesh),
               8: sh.make_topn_fn(scfg, mesh, 8),
               40: sh.make_topn_fn(scfg, mesh, 40)}
        get = lambda key: jnp.asarray(inputs[f"{name}/{key}"])
        state, rec = sh.init_sharded(scfg, mesh), {}
        for j, (op, arg) in enumerate(plan):
            if op == "update":
                state = fns[op](state, get(f"src{arg}"), get(f"dst{arg}"),
                                get(f"w{arg}"))
            elif op in ("maintain", "decay"):
                state = fns[op](state)
            elif op == "query":
                out = fns[op](state, get(f"q{arg}"))
                rec.update({f"{j}/{k}": np.asarray(v) for k, v in
                            zip(("dsts", "probs", "n_needed", "dropped"), out)})
            else:
                out = fns[arg](state)
                rec.update({f"{j}/{k}": np.asarray(v) for k, v in
                            zip(("srcs", "dsts", "probs", "dropped"), out)})
            if op in ("update", "maintain", "decay"):
                rec.update({f"{j}/{k}": v for k, v in leaves(state).items()})
        np.savez(os.path.join(out_dir, name + ".npz"), **rec)

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(run, scenarios.items()))
    print("JAX-SHARDED-OK")
    """ % dict(threshold=THRESHOLD))


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    """Every scenario's calls through the reference, in one subprocess:
    ``{scenario: {"<call index>/<name>": array}}``."""
    tmp = tmp_path_factory.mktemp("sharded")
    np.savez(tmp / "inputs.npz", **{f"{name}/{k}": v for name in SCENARIOS
                                    for k, v in _inputs(name).items()})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "inputs.npz"), str(tmp),
         json.dumps(SCENARIOS), json.dumps(PLAN)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-SHARDED-OK" in out.stdout
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in SCENARIOS}


def _config(name):
    spec = SCENARIOS[name]
    own = (Ownership(num_shards=spec["shards"], assignment=spec["assignment"])
           if spec.get("assignment") else None)
    return tsh.ShardedConfig(base=tmc.MCConfig(**spec["base"]),
                             num_shards=spec["shards"],
                             bucket_factor=spec["factor"], ownership=own)


def _state_leaves(rec, j):
    return {name: rec[f"{j}/{name}"] for name in convert.LEAF_NAMES}


def _outputs(rec, j, names):
    return {k: rec[f"{j}/{k}"] for k in names}


_QUERY = ("dsts", "probs", "n_needed", "dropped")
_TOPN = ("srcs", "dsts", "probs", "dropped")


def _replay(name, rec, state, scfg, start=0, *, calls=None, armed=None):
    """Run the plan from call ``start`` on ``state`` and compare with the
    reference's records after every call.  ``calls`` maps a state call to
    the port's form (default: the owner calls); ``armed`` (the guard of
    ``no_clone_or_host_read``) is raised around the owner calls."""
    inputs = _inputs(name)
    calls = calls or {
        "update": lambda st, src, dst, w: tsh.update_(st, src, dst, w, scfg=scfg),
        "maintain": lambda st: tsh.maintain_(st, scfg=scfg,
                                             total_threshold=THRESHOLD),
        "decay": lambda st: tsh.decay_(st, scfg=scfg)}
    for j, (op, arg) in enumerate(PLAN[start:], start):
        if armed is not None:
            armed[0] = op != "topn"
        if op == "update":
            state = calls[op](state, inputs[f"src{arg}"], inputs[f"dst{arg}"],
                              inputs[f"w{arg}"])
        elif op in ("maintain", "decay"):
            state = calls[op](state)
        elif op == "query":
            got = tsh.query(state, inputs[f"q{arg}"], 0.9, 8, scfg=scfg)
        else:
            got = tsh.topn(state, arg, scfg=scfg)
        if armed is not None:
            armed[0] = False
        what = f"{name} call {j} {op}({arg})"
        if op in ("query", "topn"):
            keys = _QUERY if op == "query" else _TOPN
            assert_same(_outputs(rec, j, keys), dict(zip(keys, got)), what)
        else:
            assert_same(_state_leaves(rec, j),
                        convert.sharded_state_to_numpy(state), what)
    return state


# ---------------------------------------------------------------------------
# the streams
# ---------------------------------------------------------------------------


def _storage(state):
    """Every leaf tensor of a state (to check that the owner calls keep
    each one in its storage)."""
    return (*state.src_table, *state.slabs, state.dh_keys, state.dh_vals,
            *(getattr(state, f) for f in tmc.SCALAR_FIELDS))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_owner_calls_equal_the_reference_after_every_call(name, jax_records,
                                                          monkeypatch):
    """Update, maintain, threshold query, decay and the top-n at n 8 and
    40: every stacked leaf and output equal to the reference's after every
    call, the owner calls with no clone and no host read, every leaf kept
    in its storage."""
    scfg = _config(name)
    rec = jax_records[name]
    state = tsh.init_sharded(scfg, device="cpu")
    ptrs = [x.data_ptr() for x in _storage(state)]
    with no_clone_or_host_read(monkeypatch) as armed:
        out = _replay(name, rec, state, scfg, armed=armed)
    assert out is state and [x.data_ptr() for x in _storage(state)] == ptrs
    stats = tmc.counter_stats(state)
    assert stats["decay_steps"] > 0 and stats["n_rows"] > 0, stats
    if name == "s4_drops":
        assert stats["route_dropped"] > 0
        assert any(rec[f"{j}/dropped"].sum() > 0 for j, (op, _) in
                   enumerate(PLAN) if op == "query")
    elif SCENARIOS[name]["factor"] >= 4.0:
        assert stats["route_dropped"] == 0, stats


@pytest.mark.parametrize("name", ["s4_rolling", "s2_stw"])
def test_functional_calls_write_nothing_and_equal_the_owner_calls(
        name, jax_records):
    """The ``make_*_fn`` callables leave every leaf of the state they are
    given as it was, and give the reference's states, as the owner calls
    do."""
    scfg = _config(name)
    fns = {"update": tsh.make_update_fn(scfg),
           "maintain": tsh.make_maintain_fn(scfg, THRESHOLD),
           "decay": tsh.make_decay_fn(scfg)}

    def checked(fn):
        def call(state, *args):
            before = convert.sharded_state_to_numpy(state)
            out = fn(state, *args)
            assert_same(before, convert.sharded_state_to_numpy(state),
                        "a functional call wrote its input")
            assert out.slabs.cnt.data_ptr() != state.slabs.cnt.data_ptr()
            return out
        return call

    _replay(name, jax_records[name], tsh.init_sharded(scfg, device="cpu"),
            scfg, calls={k: checked(f) for k, f in fns.items()})
    query, topn = tsh.make_query_fn(scfg, 0.9, 8), tsh.make_topn_fn(scfg, 8)
    state = tsh.init_sharded(scfg, device="cpu")
    inputs = _inputs(name)
    fns["update"](state, inputs["src0"], inputs["dst0"], inputs["w0"])
    assert int(state.slabs.tot.sum()) == 0
    assert query(state, inputs["q0"])[2].sum() == 0
    assert topn(state)[0].tolist() == [EMPTY] * 8


def test_a_reference_state_continues_in_the_port_and_back(jax_records):
    """The reference's stacked state after the third batch, carried into
    the port (``sharded_state_from_numpy``), continues through the rest of
    the stream equal to the reference; and a port state carried into the
    reference (one shard, in this process) takes three more batches equal
    to the port."""
    name = "s4_rolling"
    scfg, rec = _config(name), jax_records[name]
    start = PLAN.index(("update", 3))
    leaves = _state_leaves(rec, max(j for j, (op, _) in enumerate(PLAN[:start])
                                    if op in ("update", "maintain", "decay")))
    state = convert.sharded_state_from_numpy(leaves, scfg, device="cpu")
    assert_same(leaves, convert.sharded_state_to_numpy(state), "round trip")
    _replay(name, rec, state, scfg, start)
    with pytest.raises(ValueError, match="wants a leading 2"):
        convert.sharded_state_from_numpy(_state_leaves(rec, 0), _config("s2_stw"),
                                         device="cpu")
    # the port -> the reference, at one shard
    one = _config("s1_stw")
    jcfg = jsh.ShardedConfig(base=jmc.MCConfig(**STW), num_shards=1,
                             bucket_factor=4.0)
    mesh = compat.make_mesh((1,), ("shard",))
    update = jsh.make_update_fn(jcfg, mesh)
    tstate = tsh.init_sharded(one, device="cpu")
    inputs = _inputs("s1_stw")
    for b in range(2):
        tsh.update_(tstate, inputs[f"src{b}"], inputs[f"dst{b}"],
                    inputs[f"w{b}"], scfg=one)
    leaves = convert.sharded_state_to_numpy(tstate)
    jstate = jmc.MCState(*(
        type(field)(*(jnp.asarray(leaves[f"{name}.{sub}"])
                      for sub in field._fields))
        if hasattr(field, "_fields") else jnp.asarray(leaves[name])
        for name, field in zip(jmc.MCState._fields, jsh.init_sharded(jcfg, mesh))))
    for b in range(2, 5):
        args = [inputs[f"{k}{b}"] for k in ("src", "dst", "w")]
        jstate = update(jstate, *map(jnp.asarray, args))
        tsh.update_(tstate, *args, scfg=one)
        assert_same(jstate, tstate, f"port -> reference, batch {b}")


@pytest.mark.parametrize("width", [8, 64, 512])
@pytest.mark.parametrize("n", [1, 8, 40])
def test_local_top_k_is_lax_top_k_in_one_and_two_stages(width, n):
    """The shard's exact top-k — the first n of a stable descending sort —
    against ``lax.top_k`` on values full of ties (small counts over small
    totals) and zeros, over rows of ``width`` entries (at least n)."""
    rng = np.random.default_rng(width + n)
    width = max(width, n)
    cnt = rng.integers(0, 4, (3, width))
    x = np.where(cnt > 0, cnt / rng.integers(1, 6, (3, width)), 0.0).astype(np.float32)
    want = jax.lax.top_k(jnp.asarray(x), n)
    got = tsh._top_k(torch.from_numpy(x), n)
    assert_same(want, got, f"top_k n={n} width={width}")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards,factor,assignment", [
    (1, 0.25, None), (3, 0.5, None), (4, 0.5, None), (4, 1.0, "reassigned"),
    (8, 0.5, None)])
def test_predict_route_overflow_equals_the_reference_and_the_drop_mask(
        shards, factor, assignment):
    """The host-side prediction equals the reference's and the port's own
    bucket drops, item by item, over skewed padded batches; an update adds
    each sender's predicted drops to its own shard's ``route_dropped``."""
    assign = _reassigned(shards) if assignment else ()
    base = dict(num_rows=64, capacity=8)
    scfg = tsh.ShardedConfig(base=tmc.MCConfig(**base), num_shards=shards,
                             bucket_factor=factor,
                             ownership=Ownership(shards, assignment=assign))
    jcfg = jsh.ShardedConfig(base=jmc.MCConfig(**base), num_shards=shards,
                             bucket_factor=factor,
                             ownership=JOwnership(shards, assignment=assign))
    rng = np.random.default_rng(shards)
    state = tsh.init_sharded(scfg, device="cpu")
    for trial in range(6):
        size = shards * int(rng.integers(1, 40))
        src = np.where(rng.random(size) < 0.6, rng.integers(0, 4, size),
                       rng.integers(0, 500, size)).astype(np.int32)
        src[rng.random(size) < 0.15] = -1
        want = jsh.predict_route_overflow(jcfg, src)
        got = tsh.predict_route_overflow(scfg, src)
        np.testing.assert_array_equal(got, want)
        cap = scfg.bucket_capacity(size // shards)
        owner = scfg.resolved_ownership().owner_of(torch.from_numpy(src))
        _, pos, dropped = tsh._build_buckets(
            [torch.from_numpy(src)], owner, shards, cap, torch.from_numpy(src >= 0))
        np.testing.assert_array_equal((pos.numpy() >= cap) & (src >= 0), got)
        np.testing.assert_array_equal(
            dropped.numpy(), got.reshape(shards, -1).sum(axis=1))
        before = state.route_dropped.clone()
        tsh.update_(state, src, src % 7, np.ones_like(src), scfg=scfg)
        np.testing.assert_array_equal((state.route_dropped - before).numpy(),
                                      got.reshape(shards, -1).sum(axis=1))
    if shards > 1:
        with pytest.raises(ValueError, match="not padded"):
            tsh.predict_route_overflow(scfg, np.zeros(shards + 1, np.int32))


_OWNERSHIPS = {
    "default4": dict(num_shards=4), "default3": dict(num_shards=3),
    "default1": dict(num_shards=1), "buckets64_s8": dict(num_shards=8, num_buckets=64),
    "reassigned": dict(num_shards=4, assignment=_reassigned()),
}


@pytest.mark.parametrize("kw", list(_OWNERSHIPS.values()), ids=list(_OWNERSHIPS))
def test_ownership_equals_the_reference(kw):
    """``bucket_of``/``owner_of`` over ids with negatives and the int32
    extremes, ``resolved_assignment``, ``reassign``, ``with_num_shards`` and
    ``shards_of_buckets``; the table is built once per device."""
    ids = np.concatenate([np.arange(-300, 3000), [2**31 - 1, -2**31, 2**20]]
                         ).astype(np.int32)
    jown, town = JOwnership(**kw), Ownership(**kw)
    np.testing.assert_array_equal(np.asarray(jown.bucket_of(jnp.asarray(ids))),
                                  town.bucket_of(torch.from_numpy(ids)).numpy())
    np.testing.assert_array_equal(np.asarray(jown.owner_of(jnp.asarray(ids))),
                                  town.owner_of(torch.from_numpy(ids)).numpy())
    assert town.resolved_assignment() == jown.resolved_assignment()
    assert town.table() is town.table("cpu")
    moved_j, moved_t = jown.reassign(5, 0), town.reassign(5, 0)
    assert moved_t.assignment == moved_j.assignment and moved_t.num_shards == kw["num_shards"]
    assert town.with_num_shards(6).resolved_assignment() == \
        jown.with_num_shards(6).resolved_assignment()
    assert town.shards_of_buckets() == jown.shards_of_buckets()
    assert hash(town) == hash(Ownership(**kw))
    np.testing.assert_array_equal(
        tsh.owner_of(torch.from_numpy(ids), kw["num_shards"]).numpy(),
        np.asarray(jsh.owner_of(jnp.asarray(ids), kw["num_shards"])))


@pytest.mark.parametrize("make", [
    lambda o: o(num_shards=0), lambda o: o(num_shards=2, num_buckets=12),
    lambda o: o(num_shards=2, num_buckets=0),
    lambda o: o(num_shards=2, num_buckets=4, assignment=(0, 1)),
    lambda o: o(num_shards=2, num_buckets=4, assignment=(0, 1, 2, 0)),
    lambda o: o(num_shards=2).reassign(256, 0),
    lambda o: o(num_shards=2).reassign(3, 2),
], ids=["no_shards", "buckets_not_pow2", "no_buckets", "short_assignment",
        "shard_out_of_range", "bucket_out_of_range", "reassign_out_of_range"])
def test_ownership_refuses_what_the_reference_refuses(make):
    with pytest.raises(ValueError) as want:
        make(JOwnership)
    with pytest.raises(ValueError) as got:
        make(Ownership)
    assert str(got.value) == str(want.value)


def test_config_refuses_an_ownership_of_another_shard_count():
    scfg = tsh.ShardedConfig(base=tmc.MCConfig(num_rows=8, capacity=4),
                             num_shards=2, ownership=Ownership(num_shards=3))
    with pytest.raises(ValueError, match="maps 3 shards but config has 2"):
        scfg.resolved_ownership()
    state = tsh.init_sharded(tsh.ShardedConfig(
        base=tmc.MCConfig(num_rows=8, capacity=4), num_shards=2), device="cpu")
    with pytest.raises(ValueError, match="not a multiple of num_shards=2"):
        tsh.update_(state, [1, 2, 3], [1, 2, 3], [1, 1, 1],
                    scfg=tsh.ShardedConfig(base=tmc.MCConfig(num_rows=8, capacity=4),
                                           num_shards=2))


# ---------------------------------------------------------------------------
# the reference's sharded-serving claims (tests/test_sharded_engine.py:50-165)
# replayed on the port
# ---------------------------------------------------------------------------


def _distinct_count_batch(n_src=12, n_dst=5, seed=0):
    srcs, dsts = [], []
    for s in range(n_src):
        for d in range(n_dst):
            srcs += [s] * (d + 1)
            dsts += [d] * (d + 1)
    src, dst = np.array(srcs, np.int32), np.array(dsts, np.int32)
    perm = np.random.default_rng(seed).permutation(src.size)
    return src[perm], dst[perm]


def test_topn_merge_matches_flat_topk():
    rng = np.random.default_rng(3)
    s, m, n = 4, 6, 8
    probs = np.sort(rng.random((s, m)).astype(np.float32), axis=1)[:, ::-1].copy()
    dsts = rng.integers(0, 100, (s, m)).astype(np.int32)
    srcs = rng.integers(0, 100, (s, m)).astype(np.int32)
    ms, md, mp = (x.numpy() for x in tops.topn_merge(
        torch.from_numpy(probs), torch.from_numpy(dsts), torch.from_numpy(srcs),
        n=n))
    assert np.all(np.diff(mp) <= 0)
    np.testing.assert_array_equal(mp, np.sort(probs.reshape(-1))[::-1][:n])
    for i in range(n):
        hits = np.argwhere(probs == mp[i])
        assert any(dsts[a, b] == md[i] and srcs[a, b] == ms[i] for a, b in hits)


def test_topn_merge_dead_tail_is_empty():
    probs = torch.tensor([[0.5, 0.0], [0.25, 0.0]])
    dsts = torch.tensor([[7, -1], [9, -1]], dtype=torch.int32)
    srcs = torch.tensor([[1, -1], [2, -1]], dtype=torch.int32)
    ms, md, mp = tops.topn_merge(probs, dsts, srcs, n=4)
    assert mp.tolist() == [0.5, 0.25, 0.0, 0.0]
    assert md.tolist() == [7, 9, EMPTY, EMPTY]
    assert ms.tolist() == [1, 2, EMPTY, EMPTY]


def test_roomy_buckets_bit_identical_to_local_oracle():
    """With roomy buckets the sharded path IS the local path: no drops,
    answers bit-identical to the unsharded chain's."""
    base = tmc.MCConfig(num_rows=64, capacity=16, sort_passes=4)
    scfg = tsh.ShardedConfig(base=base, num_shards=1, bucket_factor=4.0)
    state = tsh.init_sharded(scfg, device="cpu")
    src, dst = _distinct_count_batch()
    tsh.update_(state, src, dst, np.ones_like(src), scfg=scfg)
    assert int(state.route_dropped.sum()) == 0
    local = tmc.update_batch(tmc.init(base, device="cpu"), src, dst, cfg=base)
    q = np.arange(12, dtype=np.int32)
    d, p, n, qdrop = tsh.make_query_fn(scfg, 0.9, 8)(state, q)
    d0, p0, n0 = tmc.query_threshold(local, q, 0.9, cfg=base, max_items=8)
    assert int(qdrop.sum()) == 0
    assert torch.equal(d, d0) and torch.equal(p, p0) and torch.equal(n, n0)


def test_tiny_buckets_count_drops_and_stay_sorted():
    """An under-provisioned bucket factor drops items — counted, never
    corrupting: surviving answers stay sorted, dropped ones are EMPTY/0."""
    base = tmc.MCConfig(num_rows=64, capacity=16, sort_passes=4)
    scfg = tsh.ShardedConfig(base=base, num_shards=1, bucket_factor=0.25)
    state = tsh.init_sharded(scfg, device="cpu")
    src, dst = _distinct_count_batch()
    b = src.size
    cap = scfg.bucket_capacity(b)
    tsh.update_(state, src, dst, np.ones_like(src), scfg=scfg)
    assert int(state.route_dropped.sum()) == b - cap
    d, p, n, qdrop = tsh.query(state, np.arange(12, dtype=np.int32), 0.9, 8,
                               scfg=scfg)
    q_cap = scfg.bucket_capacity(12)
    assert int(qdrop.sum()) == 12 - q_cap
    assert bool((p[:, 1:] <= p[:, :-1]).all())
    assert bool((d[q_cap:] == EMPTY).all()) and bool((p[q_cap:] == 0.0).all())


def test_padding_consumes_no_bucket_capacity():
    """Inactive (-1) padding items neither displace real items nor count as
    drops."""
    base = tmc.MCConfig(num_rows=64, capacity=16, sort_passes=2)
    scfg = tsh.ShardedConfig(base=base, num_shards=1, bucket_factor=1.0)
    state = tsh.init_sharded(scfg, device="cpu")
    src = np.array([0] * 8 + [-1] * 8, np.int32)
    dst = np.array(list(range(8)) + [0] * 8, np.int32)
    tsh.update_(state, src, dst, np.ones(16, np.int32), scfg=scfg)
    assert int(state.route_dropped.sum()) == 0
    assert int(state.slabs.tot.sum()) == 8


def test_shard_state_is_views_into_the_stacked_storage():
    """``init_sharded`` stacks S chains, the scalars as columns of one
    ``[S, 10]`` tensor; ``shard_state`` hands out views an owner call
    writes through, and leaves the other shards as they were."""
    scfg = tsh.ShardedConfig(base=tmc.MCConfig(num_rows=16, capacity=4),
                             num_shards=3)
    state = tsh.init_sharded(scfg, device="cpu")
    assert state.slabs.cnt.shape == (3, 16, 4) and state.n_rows.shape == (3,)
    assert state.n_rows.stride() == (len(tmc.SCALAR_FIELDS),)
    one = tsh.shard_state(state, 1)
    assert tmc.scalars_of(one).data_ptr() == state.n_rows.data_ptr() + 4 * 10
    tmc.update_batch_(one, [5, 6], [1, 2], cfg=scfg.base)
    assert state.n_rows.tolist() == [0, 2, 0]
    assert int(state.slabs.tot[1].sum()) == 2 and int(state.slabs.tot.sum()) == 2
