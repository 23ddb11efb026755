"""The sharded chain one shard a process rank (``core.sharded`` with a
``sharding.ranks.RankGroup``) against the reference's ``shard_map`` chain
on 4 host devices, tolerance 0.

Two kinds of subprocess run side by side, once for the whole file (a
module-scoped fixture): the reference (``--xla_force_host_platform_device_
count=4``, its ``make_update_fn`` / ``make_query_fn`` / ``make_maintain_fn``
/ ``make_decay_fn`` / ``make_topn_fn`` over a ``("shard",)`` mesh), writing
every stacked leaf after every state call and every output to an ``.npz``;
and a group of 4 ranks over gloo on the CPU (``tests/torch_ranks_worker.py``),
which replays the same global batches, each rank its slice, and writes
what it recorded.  Before the group starts, this process runs the one-card
stacked port over the same calls and snapshots it, so that the group
restores that snapshot and this process the group's.  Each subprocess and
the group are killed after 120 s, and the test then fails naming the rank.

The batches are skewed (8 hot srcs take 60 % of a batch) and the buckets
hold the fair share only (``bucket_factor=1.0``), so updates and queries
drop items to routing.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.core import sharded as tsh
from repro_torch.kernels import ops as tops
from repro_torch.persist import snapshot
from repro_torch.sharding.ranks import RankGroup

from torch_parity import assert_same

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
BASE = dict(num_rows=256, capacity=32, sort_passes=4)
FACTOR, THRESHOLD, BATCHES = 1.0, 12, 5
PER_RANK, QUERIES_PER_RANK = 48, 16
LIMIT_S = 120
META = {"num_shards": WORLD, "wal_seq": 3, "note": "rank group"}
QUERY = ("dsts", "probs", "n_needed", "dropped")
TOPN = ("srcs", "dsts", "probs", "dropped")


def _plan():
    ops = []
    for b in range(BATCHES):
        ops += [("update", b), ("maintain", b), ("query", b)]
        if b % 2:
            ops.append(("decay", b))
        if b in (2, BATCHES - 1):
            ops += [("topn", 8), ("topn", 40)]
    return ops


PLAN = _plan()
STATE_CALLS = [j for j, (op, _) in enumerate(PLAN)
               if op in ("update", "maintain", "decay")]


def _inputs():
    """Seeded global batches: 8 hot srcs take 60 % of a batch, a few
    negative dsts, weights 1-3, padding (-1) at a batch's tail and
    scattered, unknown query srcs."""
    rng = np.random.default_rng(29)
    out = {}
    size = PER_RANK * WORLD
    for b in range(BATCHES):
        hot = rng.random(size) < 0.6
        src = np.where(hot, rng.integers(0, 8, size), rng.integers(0, 90, size))
        if b == 1:
            src[-7:] = -1
        if b == 3:
            src[rng.random(size) < 0.1] = -1
        dst = rng.integers(0, 40, size)
        dst[rng.random(size) < 0.03] = -5
        q = np.where(rng.random(QUERIES_PER_RANK * WORLD) < 0.5,
                     rng.integers(0, 8, QUERIES_PER_RANK * WORLD),
                     rng.integers(0, 100, QUERIES_PER_RANK * WORLD))
        q[-3:] = -1
        out.update({f"src{b}": src, f"dst{b}": dst, f"q{b}": q,
                    f"w{b}": rng.integers(1, 4, size)})
    return {k: v.astype(np.int32) for k, v in out.items()}


SCRIPT = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.core import mcprioq as mc, sharded as sh

    inputs, out_path = np.load(sys.argv[1]), sys.argv[2]
    spec = json.loads(sys.argv[3])
    scfg = sh.ShardedConfig(base=mc.MCConfig(**spec["base"]),
                            num_shards=spec["world"],
                            bucket_factor=spec["factor"])
    mesh = compat.make_mesh((spec["world"],), ("shard",))
    fns = {"update": sh.make_update_fn(scfg, mesh),
           "query": sh.make_query_fn(scfg, mesh, 0.9, 8),
           "maintain": sh.make_maintain_fn(scfg, mesh, spec["threshold"]),
           "decay": sh.make_decay_fn(scfg, mesh),
           8: sh.make_topn_fn(scfg, mesh, 8),
           40: sh.make_topn_fn(scfg, mesh, 40)}

    def leaves(state):
        out = {}
        for field, leaf in zip(state._fields, state):
            if hasattr(leaf, "_fields"):
                for sub, x in zip(leaf._fields, leaf):
                    out[f"{field}.{sub}"] = np.asarray(x)
            else:
                out[field] = np.asarray(leaf)
        return out

    get = lambda key: jnp.asarray(inputs[key])
    state, rec = sh.init_sharded(scfg, mesh), {}
    for j, (op, arg) in enumerate(spec["plan"]):
        if op == "update":
            state = fns[op](state, get(f"src{arg}"), get(f"dst{arg}"),
                            get(f"w{arg}"))
        elif op in ("maintain", "decay"):
            state = fns[op](state)
        else:
            out = fns[op](state, get(f"q{arg}")) if op == "query" \\
                else fns[arg](state)
            names = (("dsts", "probs", "n_needed", "dropped") if op == "query"
                     else ("srcs", "dsts", "probs", "dropped"))
            rec.update({f"{j}/{k}": np.asarray(v) for k, v in zip(names, out)})
        if op in ("update", "maintain", "decay"):
            rec.update({f"{j}/{k}": v for k, v in leaves(state).items()})
    np.savez(out_path, **rec)
    print("JAX-RANKS-OK")
    """)


def _spec():
    return {"world": WORLD, "base": BASE, "factor": FACTOR,
            "threshold": THRESHOLD, "batches": BATCHES, "meta": META,
            "plan": [list(p) for p in PLAN]}


def _config(world=WORLD):
    return tsh.ShardedConfig(base=tmc.MCConfig(**BASE), num_shards=world,
                             bucket_factor=FACTOR)


def _one_card(inputs):
    """The one-card stacked port over the plan: its state after every
    state call (numpy leaves) and its final state."""
    scfg = _config()
    state, after = tsh.init_sharded(scfg, device="cpu"), {}
    for j, (op, arg) in enumerate(PLAN):
        if op == "update":
            tsh.update_(state, *(inputs[f"{k}{arg}"] for k in ("src", "dst", "w")),
                        scfg=scfg)
        elif op == "maintain":
            tsh.maintain_(state, scfg=scfg, total_threshold=THRESHOLD)
        elif op == "decay":
            tsh.decay_(state, scfg=scfg)
        if op in ("update", "maintain", "decay"):
            after[j] = convert.sharded_state_to_numpy(state)
    return after, state


def _start(args, env, log):
    """A subprocess with its output in the file ``log`` (no pipe to fill)."""
    with open(log, "w") as out:
        return subprocess.Popen(args, env=env, stdout=out,
                                stderr=subprocess.STDOUT, text=True)


def _wait(procs, logs, names, deadline):
    """Wait for every process; the first that fails or outlives the
    deadline kills them all and fails the test, naming it."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(name, c) for name, c in zip(names, codes) if c not in (None, 0)]
        if bad or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            who = (f"{bad[0][0]} exited with {bad[0][1]}" if bad else
                   f"{[n for n, c in zip(names, codes) if c is None]} ran past "
                   f"{LIMIT_S} s and were killed")
            pytest.fail(f"{who}:\n" + "\n".join(
                f"--- {n}\n{Path(log).read_text()[-3000:]}"
                for n, log in zip(names, logs)))
        if all(c == 0 for c in codes):
            return [Path(log).read_text() for log in logs]
        time.sleep(0.05)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference records, [rank records], one-card states, workdir)``."""
    work = tmp_path_factory.mktemp("ranks")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    (work / "spec.json").write_text(json.dumps(_spec()))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    deadline = time.monotonic() + LIMIT_S
    names = ["the reference", *(f"rank {r}" for r in range(WORLD))]
    logs = [work / f"log{i}.txt" for i in range(len(names))]
    reference = _start([sys.executable, "-c", SCRIPT, str(work / "inputs.npz"),
                        str(work / "reference.npz"), json.dumps(_spec())],
                       env, logs[0])
    try:
        after, state = _one_card(inputs)
        snapshot.save_snapshot(state, str(work / "one_snap"), 7, META)
    except BaseException:
        reference.kill()
        reference.wait()
        raise
    group = [_start([sys.executable, str(ROOT / "tests" / "torch_ranks_worker.py"),
                     str(r), str(WORLD), str(work)], env, logs[1 + r])
             for r in range(WORLD)]
    outs = _wait([reference, *group], logs, names, deadline)
    assert "JAX-RANKS-OK" in outs[0]
    rec = dict(np.load(work / "reference.npz"))
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    return rec, ranks, (after, state), work


def _shard(rec, j, r):
    """Shard r of the reference's stacked leaves after call j, leading 1."""
    return {k: rec[f"{j}/{k}"][r:r + 1] for k in convert.LEAF_NAMES}


def _rank_leaves(got, prefix):
    return {k: got[f"{prefix}/{k}"] for k in convert.LEAF_NAMES}


# ---------------------------------------------------------------------------
# (i)-(iv): every rank against the reference
# ---------------------------------------------------------------------------


def test_the_collectives_keep_the_reference_layout(runs):
    """``all_to_all`` is tiled on dim 0, sender 0's block first;
    ``all_gather`` stacks in rank order; ``psum`` sums; ``gather`` and
    ``scatter`` in several point-to-point pieces to and from a rank other
    than 0 concatenate and split along dim 0."""
    _, ranks, _, _ = runs
    for r, got in enumerate(ranks):
        want = np.stack([np.arange(3, dtype=np.int32) + 3 * r + 100 * j
                         for j in range(WORLD)])
        np.testing.assert_array_equal(got["layout/all_to_all"], want)
        np.testing.assert_array_equal(
            got["layout/all_gather"],
            np.array([[j, -j] for j in range(WORLD)], np.float32))
        np.testing.assert_array_equal(got["layout/psum"], [10, 40])
        np.testing.assert_array_equal(
            got["layout/scatter"],
            np.arange(WORLD * 2 * 37).reshape(WORLD * 2, 37)[2 * r:2 * r + 2])
        assert ("layout/gather" in got) == (r == 1)
    np.testing.assert_array_equal(
        ranks[1]["layout/gather"],
        np.stack([np.arange(37) * (j + 1) for j in range(WORLD)]))


@pytest.mark.parametrize("rank", range(WORLD))
def test_a_rank_equals_the_reference_shard_after_every_call(runs, rank):
    """(i) After every update, maintain and decay, rank r's 18 leaves are
    the reference's shard r, bit for bit."""
    rec, ranks, _, _ = runs
    for j in STATE_CALLS:
        assert_same(_shard(rec, j, rank),
                    _rank_leaves(ranks[rank], f"owner/{j}"),
                    f"rank {rank} after call {j} {PLAN[j]}")


@pytest.mark.parametrize("rank", range(WORLD))
def test_a_rank_answers_its_slice_of_the_reference_query(runs, rank):
    """(ii) Each rank's answers, ``n_needed`` and drops are the reference's
    slice for that rank; the stream drops queries to routing."""
    rec, ranks, _, _ = runs
    b = QUERIES_PER_RANK
    dropped = 0
    for j, (op, _) in enumerate(PLAN):
        if op != "query":
            continue
        want = {k: rec[f"{j}/{k}"][rank * b:(rank + 1) * b] for k in QUERY[:3]}
        want["dropped"] = rec[f"{j}/dropped"][rank:rank + 1]
        got = {k: ranks[rank][f"owner/{j}/{k}"] for k in QUERY}
        assert_same(want, got, f"rank {rank} query at call {j}")
        dropped += int(rec[f"{j}/dropped"].sum())
    assert dropped > 0, "the skewed queries dropped nothing to routing"


def test_the_top_n_is_the_reference_on_every_rank(runs):
    """(iii) The global top-n at n 8 and 40, the same on every rank, is
    the reference's replicated answer, drops included."""
    rec, ranks, _, _ = runs
    for j, (op, n) in enumerate(PLAN):
        if op != "topn":
            continue
        want = {k: rec[f"{j}/{k}"] for k in TOPN}
        assert (want["probs"] > 0).sum() > 0
        for r, got in enumerate(ranks):
            assert_same(want, {k: got[f"owner/{j}/{k}"] for k in TOPN},
                        f"rank {r} top-{n} at call {j}")


@pytest.mark.parametrize("rank", range(WORLD))
def test_route_dropped_grows_by_the_predicted_overflow(runs, rank):
    """(iv) Each update adds to rank r's ``route_dropped`` what
    ``predict_route_overflow`` drops in rank r's slice of the batch."""
    _, ranks, _, _ = runs
    inputs, scfg = _inputs(), _config()
    before = 0
    for j, (op, arg) in enumerate(PLAN):
        if op != "update":
            continue
        mask = tsh.predict_route_overflow(scfg, inputs[f"src{arg}"])
        after = int(ranks[rank][f"owner/{j}/route_dropped"][0])
        assert after - before == int(mask.reshape(WORLD, -1)[rank].sum()), \
            f"rank {rank}, update {arg}"
        before = after
    assert sum(int(r[f"owner/{STATE_CALLS[-1]}/route_dropped"][0])
               for r in ranks) > 0, "no update dropped to routing"


# ---------------------------------------------------------------------------
# (v) the functional forms and the learner
# ---------------------------------------------------------------------------


def test_functional_forms_write_nothing_and_equal_the_owner_calls(runs):
    """(v) The ``make_*_fn`` callables (each checked in the rank to leave
    the state it is given as it was) give the owner calls' states and
    answers after every call."""
    _, ranks, _, _ = runs
    for r, got in enumerate(ranks):
        func = {k[len("func/"):]: v for k, v in got.items()
                if k.startswith("func/")}
        owner = {k[len("owner/"):]: v for k, v in got.items()
                 if k.startswith("owner/")}
        assert func.keys() == owner.keys()
        assert_same(owner, func, f"rank {r}: functional vs owner calls")


def test_a_ranks_learner_equals_its_owner_calls(runs):
    """(v) A rank's ``BackBufferLearner`` writing ``update_`` +
    ``maintain_`` (row and table flags tracked) publishes, after every
    write, the state the same owner calls give on a plain state."""
    _, ranks, _, _ = runs
    for r, got in enumerate(ranks):
        for b in range(BATCHES):
            assert_same(_rank_leaves(got, f"plain/{b}"),
                        _rank_leaves(got, f"learner/{b}"),
                        f"rank {r} learner write {b}")


# ---------------------------------------------------------------------------
# (vi) one process and back
# ---------------------------------------------------------------------------


def test_gather_sharded_and_counters_equal_the_one_card_chain(runs):
    """(vi) ``gather_sharded`` on rank 0 is the one-card stacked port fed
    the same batches (and so the reference's final state); every rank's
    ``counter_stats`` over the group is the one-card state's."""
    rec, ranks, (after, state), _ = runs
    last = STATE_CALLS[-1]
    assert_same(after[last], _rank_leaves(ranks[0], "gathered"),
                "gathered vs one card")
    assert_same({k: rec[f"{last}/{k}"] for k in convert.LEAF_NAMES},
                after[last], "one card vs the reference")
    for j in STATE_CALLS:
        assert_same({k: rec[f"{j}/{k}"] for k in convert.LEAF_NAMES},
                    after[j], f"one card vs the reference after call {j}")
    stats = tmc.counter_stats(state)
    want = np.array([stats[k] for k in sorted(stats)])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["counters"], want, f"rank {r}")
        assert not any(k.startswith("gathered/") for k in got) or r == 0


def test_the_groups_snapshot_is_the_one_card_chains_byte_for_byte(runs):
    """(vi) The files of the 4-rank group's snapshot (written by rank 0)
    are those of the one-card chain in the same state."""
    _, _, _, work = runs
    one = snapshot.step_dir(str(work / "one_snap"), 7)
    group = snapshot.step_dir(str(work / "group_snap"), 7)
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(group)) == \
        ["arrays.npz", "chain.json", "manifest.json"]
    for name in names:
        assert Path(one, name).read_bytes() == Path(group, name).read_bytes(), name


def test_a_snapshot_restores_either_way(runs):
    """(vi) The one-card chain's snapshot restores into the group, each
    rank its shard; the group's restores on one card; both equal."""
    _, ranks, (after, state), work = runs
    last = STATE_CALLS[-1]
    for r, got in enumerate(ranks):
        want = {k: v[r:r + 1] for k, v in after[last].items()}
        assert_same(want, _rank_leaves(got, "restored"), f"rank {r} restored")
    back, meta, step = snapshot.restore_snapshot(
        tsh.init_sharded(_config(), device="cpu"), str(work / "group_snap"))
    assert (meta, step) == (META, 7)
    assert_same(after[last], convert.sharded_state_to_numpy(back),
                "the group's snapshot on one card")
    tsh.update_(back, *(_inputs()[f"{k}0"] for k in ("src", "dst", "w")),
                scfg=_config())
    tsh.update_(state, *(_inputs()[f"{k}0"] for k in ("src", "dst", "w")),
                scfg=_config())
    assert_same(convert.sharded_state_to_numpy(state),
                convert.sharded_state_to_numpy(back), "an update after it")


def test_a_failed_restore_or_save_raises_on_every_rank(runs):
    """A restore from a directory with no snapshot, and a save rank 0
    cannot write, raise on every rank (none waits for the others)."""
    _, ranks, _, _ = runs
    for r, got in enumerate(ranks):
        assert "no complete snapshot" in str(got["errors/restore"]), r
        said = str(got["errors/save"])
        assert ("rank 0 failed to write" in said) == (r != 0), (r, said)


def test_rank_state_from_numpy_takes_shard_r(runs):
    """``rank_state_from_numpy`` is shard r of stacked leaves, a state the
    rank forms take (scalars packed, leading 1)."""
    _, _, (after, _), _ = runs
    leaves = after[STATE_CALLS[-1]]
    for r in range(WORLD):
        st = convert.rank_state_from_numpy(leaves, _config(), r, device="cpu")
        tmc.scalars_of(tsh.shard_state(st, 0))
        assert_same({k: v[r:r + 1] for k, v in leaves.items()},
                    convert.state_to_numpy(st), f"shard {r}")
    with pytest.raises(ValueError, match="not a shard"):
        convert.rank_state_from_numpy(leaves, _config(), WORLD, device="cpu")
    with pytest.raises(ValueError, match="leading 2"):
        convert.rank_state_from_numpy(leaves, _config(2), 0, device="cpu")


@pytest.mark.parametrize("n", [8, 40])
def test_a_ranks_own_list_is_the_same_by_windows_and_by_sort(runs, n):
    """A rank's own top-n list comes from ``ops.topn_windows`` at S = 1 on
    the card and from ``topn_lists`` on the CPU: the window kernel's plain
    mirror at S = 1 gives the same list and drop count on every rank's
    shard after every call."""
    _, _, (after, _), _ = runs
    scfg = _config()
    for j in STATE_CALLS[::3]:
        for r in range(WORLD):
            st = convert.rank_state_from_numpy(after[j], scfg, r, device="cpu")
            probs, dsts, srcs, dropped = tsh.topn_lists(st, n, scfg=scfg)
            slabs = st.slabs
            w_src, w_dst, w_p, w_drop = tops.topn_windows(
                slabs.cnt, slabs.order, slabs.tot, slabs.dst, *st.src_table,
                n=n, impl="ref")
            assert_same((probs[0], dsts[0], srcs[0], dropped),
                        (w_p, w_dst, w_src, w_drop), f"rank {r} call {j}")


# ---------------------------------------------------------------------------
# (vii) a group of the wrong size raises; no collective is reached
# ---------------------------------------------------------------------------


def _fake_group(world):
    return RankGroup(None, 0, world, torch.device("cpu"), "gloo")


_CALLS = {
    "init_sharded": lambda scfg, st, g: tsh.init_sharded(scfg, ranks=g),
    "update_": lambda scfg, st, g: tsh.update_(
        st, np.zeros(4, np.int32), np.zeros(4, np.int32),
        np.ones(4, np.int32), scfg=scfg, ranks=g),
    "query": lambda scfg, st, g: tsh.query(st, np.zeros(4, np.int32), 0.9, 8,
                                           scfg=scfg, ranks=g),
    "maintain_": lambda scfg, st, g: tsh.maintain_(
        st, scfg=scfg, total_threshold=1, ranks=g),
    "decay_": lambda scfg, st, g: tsh.decay_(st, scfg=scfg, ranks=g),
    "topn": lambda scfg, st, g: tsh.topn(st, 4, scfg=scfg, ranks=g),
    "make_update_fn": lambda scfg, st, g: tsh.make_update_fn(scfg, g)(
        st, np.zeros(4, np.int32), np.zeros(4, np.int32), np.ones(4, np.int32)),
    "make_topn_fn": lambda scfg, st, g: tsh.make_topn_fn(scfg, 4, g)(st),
}


@pytest.mark.parametrize("call", sorted(_CALLS))
@pytest.mark.parametrize("world,shards", [(4, 2), (2, 4), (1, 4)])
def test_a_group_whose_world_is_not_num_shards_raises(call, world, shards):
    """(vii) ``world != num_shards`` raises a ``ValueError`` naming both,
    before any collective."""
    scfg = _config(shards)
    state = tsh.init_sharded(_config(world), device="cpu", ranks=None)
    state = tmc.map_leaves(lambda x: x[:1], state)
    with pytest.raises(ValueError, match=f"world {world}.*num_shards={shards}"):
        _CALLS[call](scfg, state, _fake_group(world))


def test_a_rank_state_of_several_shards_raises():
    scfg = _config()
    state = tsh.init_sharded(scfg, device="cpu")
    with pytest.raises(ValueError, match="stacks 4"):
        tsh.update_(state, np.zeros(4, np.int32), np.zeros(4, np.int32),
                    np.ones(4, np.int32), scfg=scfg, ranks=_fake_group(WORLD))
