"""The dst-hash path (paper §II.2, ``use_dst_hash=True``) of the port
against the JAX package on the CPU: the per-row dst -> slot tables edited
by the new-edge pass, repaired by the decay and rebuilt when the tombstones
cross the threshold.  The same numpy inputs go through ``repro`` and
``repro_torch``; every state leaf (``dh_keys``, ``dh_vals``,
``dh_tombstones`` and ``dh_rebuilds`` included) and every query answer is
equal, tolerance zero."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.core import speculative as tspec
from repro_torch.core.epoch import BackBufferLearner, EpochStore
from repro_torch.data.synthetic import token_stream
from repro_torch.kernels import ops, ref

from test_torch_owner import no_clone_or_host_read
from torch_parity import (CHAIN_CONFIGS, assert_same, chain_stream,
                          jax_state_leaves, opt)

_BASE = dict(CHAIN_CONFIGS["rolling"], use_dst_hash=True)
CONFIGS = {
    # H = 32: the default 4 * C; the tombstones never reach a rebuild
    "rolling": _BASE,
    # H = 8 with a 16-slot window: windows wrap and fill; stop-the-world
    "stop_the_world_small_hash": dict(_BASE, decay_block_rows=0, sort_passes=2,
                                      max_new_per_batch=24, dst_table_size=8),
    # every decay that leaves a tombstone rebuilds (the block not dividing
    # the table)
    "rebuild_fraction_0": dict(_BASE, decay_block_rows=7,
                               dh_rebuild_fraction=0.0),
    # a rebuild once 2 % of the lanes are tombstones
    "rebuild_fraction_0.02": dict(_BASE, decay_block_rows=16,
                                  dh_rebuild_fraction=0.02),
}


def _configs(name, **more):
    kw = dict(CONFIGS[name], **more)
    return jmc.MCConfig(**kw), tmc.MCConfig(**kw)


def _queries(jstate, tstate, jcfg, tcfg, what):
    srcs = np.arange(-2, 70, dtype=np.int32)
    for t, k in ((0.5, 4), (1.0, 9)):
        assert_same(
            jmc.query_threshold(jstate, jnp.asarray(srcs), t, cfg=jcfg, max_items=k),
            tmc.query_threshold(tstate, srcs, t, cfg=tcfg, max_items=k),
            f"{what} query_threshold t={t}")
    assert_same(jmc.query_topk(jstate, jnp.asarray(srcs), cfg=jcfg, k=5),
                tmc.query_topk(tstate, srcs, cfg=tcfg, k=5), f"{what} query_topk")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_every_leaf_equals_jax_after_every_call(name):
    """50 batches of ``update_batch``, ``maybe_decay`` and four explicit
    ``decay`` calls: all 18 leaves and the answers equal after each; the
    invariants' dicts equal at the end, ``dst_hash_consistent`` true."""
    jcfg, tcfg = _configs(name)
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    update = jax.jit(jmc.update_batch, static_argnames="cfg")
    maybe = jax.jit(functools.partial(jmc.maybe_decay, cfg=jcfg,
                                      total_threshold=40))
    decay = jax.jit(functools.partial(jmc.decay, cfg=jcfg))
    most_tombs = 0
    for i, (src, dst, weights, mask) in enumerate(chain_stream(seed=len(name))):
        jstate = update(jstate, jnp.asarray(src), jnp.asarray(dst),
                        opt(weights, jnp.asarray), opt(mask, jnp.asarray),
                        cfg=jcfg)
        tstate = tmc.update_batch(tstate, src, dst, weights, mask, cfg=tcfg)
        assert_same(jstate, tstate, f"{name} batch {i} update_batch")
        jstate = maybe(jstate)
        tstate = tmc.maybe_decay(tstate, cfg=tcfg, total_threshold=40)
        if i in (20, 21, 22, 35):
            jstate, tstate = decay(jstate), tmc.decay(tstate, cfg=tcfg)
        assert_same(jstate, tstate, f"{name} batch {i} decay")
        most_tombs = max(most_tombs, int(tstate.dh_tombstones))
        if i % 10 == 9:
            _queries(jstate, tstate, jcfg, tcfg, f"{name} batch {i}")
    assert tmc.counter_stats(tstate) == jmc.counter_stats(jstate)
    stats = tmc.maintenance_stats(tstate)
    assert stats == jmc.maintenance_stats(jstate)
    assert tmc.counter_stats(tstate)["evictions"] > 0
    assert most_tombs > 0 or stats["dh_rebuilds"] > 0, stats
    if tcfg.dh_rebuild_fraction < 0.25:
        assert stats["dh_rebuilds"] >= 1, stats
    jinv, tinv = jmc.check_invariants(jstate, jcfg), tmc.check_invariants(tstate, tcfg)
    assert jinv == tinv and tinv["dst_hash_consistent"], (jinv, tinv)
    assert all(v for k, v in tinv.items() if k != "sorted_fraction")


def test_stream_equals_the_pallas_kernels_in_interpret_mode():
    """A shorter stream through the reference's Pallas kernels (interpret
    mode on the CPU): its classify probes the row hashes with
    ``probe_find_pallas`` and its decay runs the odd-even kernel."""
    jcfg, tcfg = _configs("rebuild_fraction_0")
    jcfg = dataclasses.replace(jcfg, impl="pallas")
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    for i, (src, dst, weights, mask) in enumerate(
            chain_stream(seed=7, n_batches=10)):
        jstate = jmc.update_batch(jstate, jnp.asarray(src), jnp.asarray(dst),
                                  opt(weights, jnp.asarray),
                                  opt(mask, jnp.asarray), cfg=jcfg)
        tstate = tmc.update_batch(tstate, src, dst, weights, mask, cfg=tcfg)
        if i % 3 == 2:
            jstate, tstate = jmc.decay(jstate, cfg=jcfg), tmc.decay(tstate, cfg=tcfg)
        assert_same(jstate, tstate, f"pallas batch {i}")
    assert tmc.maintenance_stats(tstate)["dh_rebuilds"] >= 1


def test_owner_calls_equal_jax_with_no_clone_and_no_host_read(monkeypatch):
    """``update_batch_``, ``maybe_decay_`` (firing and not) and ``decay_``
    with the dst hash against the reference's functional calls, every leaf
    equal after every call and kept in its own storage; and the port's own
    functional twins on the same stream give the same states."""
    jcfg, tcfg = _configs("rebuild_fraction_0.02", decay_block_rows=9)
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    functional = tmc.init(tcfg, device="cpu")
    leaves = (*tstate.src_table, *tstate.slabs, tstate.dh_keys, tstate.dh_vals,
              *(getattr(tstate, f) for f in tmc.SCALAR_FIELDS))
    ptrs = [x.data_ptr() for x in leaves]
    maybe = jax.jit(jmc.maybe_decay, static_argnames=("cfg", "total_threshold"))
    fired = set()
    with no_clone_or_host_read(monkeypatch) as armed:
        for i, (src, dst, weights, mask) in enumerate(
                chain_stream(seed=31, n_batches=30)):
            jstate = jmc.update_batch(
                jstate, jnp.asarray(src), jnp.asarray(dst),
                opt(weights, jnp.asarray), opt(mask, jnp.asarray), cfg=jcfg)
            functional = tmc.update_batch(functional, src, dst, weights, mask,
                                          cfg=tcfg)
            armed[0] = True
            assert tmc.update_batch_(tstate, src, dst, weights, mask,
                                     cfg=tcfg) is tstate
            armed[0] = False
            assert_same(jstate, tstate, f"update_batch_ {i}")
            assert_same(functional, tstate, f"update_batch {i}")
            steps = int(jstate.decay_steps)
            jstate = maybe(jstate, cfg=jcfg, total_threshold=12)
            fired.add(int(jstate.decay_steps) > steps)
            functional = tmc.maybe_decay(functional, cfg=tcfg, total_threshold=12)
            armed[0] = True
            tmc.maybe_decay_(tstate, cfg=tcfg, total_threshold=12)
            if i % 5 == 4:
                tmc.decay_(tstate, cfg=tcfg)
            armed[0] = False
            if i % 5 == 4:
                jstate = jmc.decay(jstate, cfg=jcfg)
                functional = tmc.decay(functional, cfg=tcfg)
            assert_same(jstate, tstate, f"decay_ {i}")
            assert_same(functional, tstate, f"decay {i}")
            assert [x.data_ptr() for x in leaves] == ptrs, i
    assert fired == {True, False}
    assert tmc.maintenance_stats(tstate)["dh_rebuilds"] >= 1


# ---------------------------------------------------------------------------
# the new-edge pass with the row hashes: both plain forms against the scan
# ---------------------------------------------------------------------------

N, C, P = 24, 4, 8
_jax_pass = jax.jit(jmc._slow_path, static_argnames="cfg")


def _learned(seed, h):
    """A chain with row hashes learned and decayed through the reference
    (tombstones in its tables), as numpy leaves."""
    cfg = jmc.MCConfig(num_rows=N, capacity=C, max_probes=P, use_dst_hash=True,
                       dst_table_size=h, impl="ref", decay_block_rows=5,
                       dh_rebuild_fraction=100.0)
    state = jmc.init(cfg)
    rng = np.random.default_rng(seed)
    for _ in range(6):
        src = rng.integers(0, 30, 48).astype(np.int32)
        dst = rng.integers(0, 40, 48).astype(np.int32)
        state = jmc.update_batch(state, jnp.asarray(src), jnp.asarray(dst), cfg=cfg)
        state = jmc.decay(state, cfg=cfg)
    return cfg, state


@pytest.mark.parametrize("seed,h", [(1, 16), (2, 4), (3, 1)])
def test_new_edge_pass_plain_forms_edit_the_row_hashes_as_the_scan(seed, h):
    """``slow_path_ref`` (sequential) and ``slow_path_rows_ref`` (the
    kernel's decomposition) with the row hashes against the reference's
    ``_slow_path`` on one learned state: items on full rows (evictions:
    delete, then an insert that may reuse the TOMB), new rows, known dsts,
    inactive items; H of 16, 4 (windows wrap) and 1."""
    cfg, state = _learned(seed, h)
    assert int(state.dh_tombstones) > 0
    rng = np.random.default_rng(seed + 50)
    items = 40
    src = rng.integers(0, 34, items).astype(np.int32)
    dst = rng.integers(0, 60, items).astype(np.int32)
    w = rng.integers(1, 4, items).astype(np.int32)
    active = rng.random(items) < 0.85
    out = _jax_pass(state, *map(jnp.asarray, (src, dst, w, active)), cfg=cfg)
    want = (out.src_table.keys, out.src_table.vals, out.slabs.dst, out.slabs.cnt,
            out.slabs.tot,
            np.array([out.n_rows, out.dropped_rows, out.dropped_probes,
                      out.evictions], np.int32), out.dh_keys, out.dh_vals)
    assert int(out.evictions) > int(state.evictions)
    leaves = jax_state_leaves(state)
    args = [torch.from_numpy(leaves[k].copy()) for k in (
        "src_table.keys", "src_table.vals", "slabs.dst", "slabs.cnt",
        "slabs.tot", "slabs.order")]
    counters = torch.tensor([int(state.n_rows), int(state.dropped_rows),
                             int(state.dropped_probes), int(state.evictions)],
                            dtype=torch.int32)
    row_hashes = [torch.from_numpy(leaves[k].copy()) for k in ("dh_keys", "dh_vals")]
    items_t = [torch.from_numpy(x) for x in (src, dst, w, active)]
    for plain in (ref.slow_path_ref, ref.slow_path_rows_ref):
        got = plain(*args, counters, *items_t, P, *row_hashes)
        assert_same(want, got, plain.__name__)
    assert not np.array_equal(np.asarray(out.dh_keys), leaves["dh_keys"])


# ---------------------------------------------------------------------------
# the reference's maintenance scenarios (tests/test_maintenance.py), replayed
# ---------------------------------------------------------------------------


def _both(kw):
    return jmc.MCConfig(**kw), tmc.MCConfig(**kw)


def _update_both(states, cfgs, src, dst, w=None):
    j, t = states
    jc, tc = cfgs
    j = jmc.update_batch(j, jnp.asarray(src), jnp.asarray(dst),
                         None if w is None else jnp.asarray(w), cfg=jc)
    return j, tmc.update_batch(t, src, dst, w, cfg=tc)


@pytest.mark.parametrize("fraction,rebuilds", [(0.25, 0), (0.0, 1)],
                         ids=["repair_only", "rebuild"])
def test_reference_scenario_one_dead_edge(fraction, rebuilds):
    """``test_decay_repair_tombstones_dead_entries_only`` and
    ``test_dh_rebuild_triggers_on_tombstone_load``: the w=1 edge dies in a
    decay; its lane becomes TOMB, or a rebuild (threshold 0) clears it."""
    cfgs = _both(dict(num_rows=8, capacity=8, sort_passes=1, use_dst_hash=True,
                      dh_rebuild_fraction=fraction, impl="ref"))
    states = (jmc.init(cfgs[0]), tmc.init(cfgs[1], device="cpu"))
    src = np.zeros(4, np.int32)
    dst = np.array([10, 11, 12, 13], np.int32)
    w = np.array([8, 4, 2, 1], np.int32)
    states = _update_both(states, cfgs, src, dst, w)
    states = (jmc.decay(states[0], cfg=cfgs[0]), tmc.decay(states[1], cfg=cfgs[1]))
    assert_same(*states, "decay")
    t = states[1]
    assert int(t.dh_rebuilds) == rebuilds
    assert int(t.dh_tombstones) == 1 - rebuilds
    assert int((t.dh_keys == tmc.TOMB).sum()) == 1 - rebuilds
    assert tmc.check_invariants(t, cfgs[1])["dst_hash_consistent"]
    rows, _ = tmc.lookup_rows(t, src[:1], cfgs[1])
    for d, live in ((13, False), (10, True)):
        _, found = tmc._find_slots(t, rows, torch.tensor([d], dtype=torch.int32),
                                   cfgs[1])
        assert bool(found[0]) == live


def test_reference_scenario_repeated_rolling_decay():
    """``test_repeated_decay_keeps_dst_hash_consistent``: 12 rounds of an
    update and a rolling decay at a 2 % rebuild fraction, every leaf and
    the invariants equal after each."""
    cfgs = _both(dict(num_rows=16, capacity=8, sort_passes=1, use_dst_hash=True,
                      decay_block_rows=4, dh_rebuild_fraction=0.02, impl="ref"))
    states = (jmc.init(cfgs[0]), tmc.init(cfgs[1], device="cpu"))
    rng = np.random.default_rng(5)
    for i in range(12):
        s = rng.integers(0, 12, 64).astype(np.int32)
        d = rng.integers(0, 12, 64).astype(np.int32)
        states = _update_both(states, cfgs, s, d)
        states = (jmc.decay(states[0], cfg=cfgs[0]),
                  tmc.decay(states[1], cfg=cfgs[1]))
        assert_same(*states, f"round {i}")
        jinv = jmc.check_invariants(states[0], cfgs[0])
        assert jinv == tmc.check_invariants(states[1], cfgs[1])
        assert jinv["dst_hash_consistent"], i
    assert tmc.maintenance_stats(states[1])["dh_rebuilds"] >= 1
    assert tmc.maintenance_stats(states[1])["decay_steps"] == 12


def test_convert_round_trip_keeps_row_hashes_wider_than_one():
    cfgs = _both(dict(num_rows=8, capacity=4, use_dst_hash=True, impl="ref"))
    j = jmc.update_batch(jmc.init(cfgs[0]), jnp.asarray([1, 2, 1], jnp.int32),
                         jnp.asarray([5, 6, 7], jnp.int32), cfg=cfgs[0])
    leaves = jax_state_leaves(j)
    t = convert.state_from_numpy(leaves, cfgs[1], device="cpu")
    assert t.dh_keys.shape == (8, 16)
    assert_same(j, t, "round trip")
    back = convert.state_to_numpy(t)
    assert all(np.array_equal(back[k], leaves[k]) for k in leaves)


# ---------------------------------------------------------------------------
# the back-buffer learner on a drafter with the dst hash
# ---------------------------------------------------------------------------

NCFG = tspec.NGramConfig(order=2, decay_threshold=12, mc=tmc.MCConfig(
    num_rows=32, capacity=4, sort_passes=1, decay_block_rows=7,
    max_new_per_batch=16, max_probes=16, use_dst_hash=True,
    dh_rebuild_fraction=0.05))


def test_back_buffer_learner_with_row_hashes_publishes_the_functional_states():
    """The learner catches its back buffer up by the flagged rows, the row
    hashes' rows included: every state it publishes equals the functional
    learner's, rebuilds and all, while a held snapshot stays bit-equal."""
    store = EpochStore(tspec.init(NCFG, device="cpu"))
    learner = BackBufferLearner(store)
    functional = tspec.init(NCFG, device="cpu")
    stream = token_stream(6, 4, 12, seed=4)
    for i in range(16):
        tokens = next(stream)["tokens"]
        functional = tspec.maintain(tspec.observe(functional, tokens, cfg=NCFG),
                                    cfg=NCFG)
        snap = learner.acquire()
        held = convert.state_to_numpy(snap.state.chain)
        published = learner.write(
            lambda s, t, dirty, table_dirty: tspec.maintain_(tspec.observe_(
                s, t, cfg=NCFG, dirty=dirty, table_dirty=table_dirty),
                cfg=NCFG, dirty=dirty), tokens)
        assert_same(functional.chain, published.chain, f"write {i}")
        now = convert.state_to_numpy(snap.state.chain)
        for name, value in held.items():
            assert np.array_equal(now[name], value), (i, name)
        store.release(snap)
    stats = tmc.maintenance_stats(functional.chain)
    assert stats["dh_rebuilds"] >= 1 and tmc.counter_stats(
        functional.chain)["evictions"] > 0, stats
    assert tmc.check_invariants(functional.chain, NCFG.mc)["dst_hash_consistent"]


def test_copy_dirty_rows_copies_the_flagged_row_hashes_only():
    rng = np.random.default_rng(9)
    n, c, h = 10, 3, 8

    def state():
        return [torch.from_numpy(rng.integers(-2, 50, shape).astype(np.int32))
                for shape in ((n, c), (n, c), (n, c), (n,), (16,), (16,), (10,),
                              (n, h), (n, h))]

    front, back = state(), state()
    kept = [x.clone() for x in back]
    dirty = torch.from_numpy((rng.random(n) < 0.5).astype(np.uint8))
    rows = dirty.bool().clone()
    ops.copy_dirty_rows(front, back, dirty, torch.zeros(1, dtype=torch.uint8))
    assert not dirty.any()
    for f, b, k in zip(front[7:], back[7:], kept[7:]):
        assert torch.equal(b[rows], f[rows]) and torch.equal(b[~rows], k[~rows])
    # without the row hashes they are not touched
    back2 = [x.clone() for x in kept]
    ops.copy_dirty_rows(front[:7], back2[:7], rows.to(torch.uint8),
                        torch.zeros(1, dtype=torch.uint8))
    assert all(torch.equal(b, k) for b, k in zip(back2[7:], kept[7:]))


@pytest.mark.parametrize("h,refused", [(4096, False), (8192, True)])
def test_row_hash_wider_than_the_rebuild_stages_is_refused_on_cuda(h, refused):
    from repro_torch.kernels import dh_rebuild
    cfg = tmc.MCConfig(num_rows=4, capacity=4, use_dst_hash=True,
                       dst_table_size=h)
    assert dh_rebuild.MAX_TABLE == 4096
    if refused:
        with pytest.raises(ValueError, match="kernels/dh_rebuild.py"):
            tmc.check_cuda_limits(cfg, "cuda")
    else:
        tmc.check_cuda_limits(cfg, "cuda")
    tmc.check_cuda_limits(dataclasses.replace(cfg, impl="ref"), "cuda")
    tmc.check_cuda_limits(cfg, "cpu")


def test_rebuild_plain_version_is_the_reference_rebuild():
    """``dh_rebuild_ref_`` with a threshold it crosses equals the reference's
    ``_dh_rebuild_all`` (and the counters move); with one it does not, or a
    false ``fire``, it writes nothing, decided without a host read."""
    cfg, state = _learned(4, 8)
    want = jmc._dh_rebuild_all(state, cfg)
    leaves = {k: torch.from_numpy(v.copy())
              for k, v in jax_state_leaves(state).items()}
    tombs = int(state.dh_tombstones)
    assert tombs > 0
    for threshold, fire, runs in ((tombs - 1, None, True), (tombs, None, False),
                                  (tombs - 1, False, False)):
        keys, vals = leaves["dh_keys"].clone(), leaves["dh_vals"].clone()
        counters = torch.tensor([3, tombs], dtype=torch.int32)
        dirty = torch.zeros(N, dtype=torch.uint8)
        ref.dh_rebuild_ref_(leaves["slabs.cnt"], leaves["slabs.dst"], keys, vals,
                            counters, threshold, P,
                            None if fire is None else torch.tensor(fire), dirty)
        if runs:
            assert_same((want.dh_keys, want.dh_vals), (keys, vals), "rebuild")
            assert counters.tolist() == [4, 0] and bool(dirty.all())
        else:
            assert torch.equal(keys, leaves["dh_keys"])
            assert counters.tolist() == [3, tombs] and not dirty.any()


@pytest.mark.parametrize("rolling", [False, True])
def test_decay_plain_forms_repair_as_the_reference(rolling):
    """The functional and in-place plain decays with the row hashes against
    the reference's decay on one learned state (the rebuild kept off)."""
    cfg, state = _learned(6, 16)
    cfg = dataclasses.replace(cfg, dh_rebuild_fraction=1.0,
                              decay_block_rows=5 if rolling else 0)
    want = jmc.decay(state, cfg=cfg)
    leaves = {k: torch.from_numpy(v.copy())
              for k, v in jax_state_leaves(state).items()}
    slab = [leaves[f"slabs.{k}"] for k in ("cnt", "dst", "order", "tot")]
    dh = (leaves["dh_keys"], leaves["dh_vals"])
    tombs = leaves["dh_tombstones"]
    if rolling:
        out = ref.decay_sort_rolling_ref(*slab, leaves["decay_cursor"], 5, *dh,
                                         tombs)
        got_keys, got_tombs = out[5], out[6]
    else:
        out = ref.decay_sort_ref(*slab[:3], *dh)
        got_keys, got_tombs = out[4], tombs + out[5]
    assert_same((want.slabs.cnt, want.dh_keys, want.dh_tombstones),
                (out[0], got_keys, got_tombs), "decay")
    assert int(want.dh_tombstones) > int(state.dh_tombstones)
    assert np.array_equal(leaves["dh_keys"].numpy(),
                          jax_state_leaves(state)["dh_keys"]), "input written"
