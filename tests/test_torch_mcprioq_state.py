"""The chain of the port beyond the batch-by-batch stream test: the sampler
copy, the seed-path oracle, state conversion and continuation across the two
packages, functional semantics, the reference under its Pallas kernels, and
the public names."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro.data.synthetic import MarkovGraphSampler as JaxSideSampler
from repro_torch import convert, core as tcore
from repro_torch.core import mcprioq as tmc
from repro_torch.data.synthetic import MarkovGraphSampler

from torch_parity import (CHAIN_CONFIGS as CONFIGS, assert_same,
                          chain_configs as _configs, chain_stream as _stream,
                          jax_state_leaves, opt as _opt)


def test_sampler_copy_gives_the_reference_streams():
    a, b = JaxSideSampler(num_nodes=50, out_degree=6, seed=3), \
        MarkovGraphSampler(num_nodes=50, out_degree=6, seed=3)
    np.testing.assert_array_equal(a.dsts, b.dsts)
    for _ in range(3):
        for x, y in zip(a.sample_transitions_mixed(32, 0.25, 7),
                        b.sample_transitions_mixed(32, 0.25, 7)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.sample_walks(4, 5), b.sample_walks(4, 5))
    for x, y in zip(a.true_probs(2), b.true_probs(2)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["stop_the_world", "unbounded_prefix_odd_capacity"])
def test_update_batch_reference_matches_the_reference_oracle(name):
    """The seed-path oracle of both packages agrees batch by batch; and where
    the reference's own tests claim it (unbounded prefix, no in-batch
    duplicates racing for one slot's eviction), update_batch agrees too."""
    jcfg, tcfg = _configs(name)
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    for i, (src, dst, weights, mask) in enumerate(_stream(seed=9, n_batches=12)):
        jstate = jmc.update_batch_reference(
            jstate, jnp.asarray(src), jnp.asarray(dst), _opt(weights, jnp.asarray),
            _opt(mask, jnp.asarray), cfg=jcfg)
        tstate = tmc.update_batch_reference(tstate, src, dst, weights, mask, cfg=tcfg)
        assert_same(jstate, tstate, f"{name} batch {i} update_batch_reference")


def test_update_batch_equals_reference_path_on_a_roomy_chain():
    """tests/test_update_path.py's claim: with room for every row and slot
    and an unbounded prefix, the kernel-routed pipeline and the O(B) oracle
    reach the same counts (slot placement may differ, so compare edges)."""
    cfg = tmc.MCConfig(num_rows=128, capacity=16, impl="ref")
    a = b = tmc.init(cfg, device="cpu")
    g = MarkovGraphSampler(num_nodes=60, out_degree=8, seed=4)
    for _ in range(6):
        src, dst = g.sample_transitions(96)
        a = tmc.update_batch(a, src, dst, cfg=cfg)
        b = tmc.update_batch_reference(b, src, dst, cfg=cfg)

    def edges(state):
        rows = {int(r): int(k) for k, r in zip(state.src_table.keys.tolist(),
                                               state.src_table.vals.tolist()) if k >= 0}
        return {(rows[r], int(d)): int(c)
                for r in rows
                for d, c in zip(state.slabs.dst[r].tolist(), state.slabs.cnt[r].tolist())
                if c > 0}

    assert edges(a) == edges(b)
    assert torch.equal(a.slabs.tot.sort().values, b.slabs.tot.sort().values)


def test_state_round_trip_and_cross_package_continuation():
    jcfg, tcfg = _configs("rolling")
    stream = list(_stream(seed=5, n_batches=16))
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    for src, dst, weights, mask in stream[:8]:
        jstate = jmc.update_batch(jstate, jnp.asarray(src), jnp.asarray(dst),
                                  _opt(weights, jnp.asarray), _opt(mask, jnp.asarray),
                                  cfg=jcfg)
        tstate = tmc.update_batch(tstate, src, dst, weights, mask, cfg=tcfg)
    # round trip inside the port
    leaves = convert.state_to_numpy(tstate)
    assert list(leaves) == list(convert.LEAF_NAMES)
    assert all(v.dtype == np.int32 for v in leaves.values())
    assert_same(tstate, convert.state_from_numpy(leaves, tcfg, "cpu"), "round trip")
    # swap: the port continues JAX's state, JAX continues the port's
    t_from_j = convert.state_from_numpy(jax_state_leaves(jstate), tcfg, "cpu")
    j_from_t = jmc.MCState(
        src_table=jmc.HashTable(jnp.asarray(leaves["src_table.keys"]),
                                jnp.asarray(leaves["src_table.vals"])),
        slabs=jmc.Slabs(*(jnp.asarray(leaves[f"slabs.{f}"]) for f in jmc.Slabs._fields)),
        **{f: jnp.asarray(leaves[f]) for f in jmc.MCState._fields
           if f not in ("src_table", "slabs")})
    for i, (src, dst, weights, mask) in enumerate(stream[8:]):
        j_from_t = jmc.update_batch(j_from_t, jnp.asarray(src), jnp.asarray(dst),
                                    _opt(weights, jnp.asarray), _opt(mask, jnp.asarray),
                                    cfg=jcfg)
        t_from_j = tmc.update_batch(t_from_j, src, dst, weights, mask, cfg=tcfg)
        j_from_t = jmc.decay(j_from_t, cfg=jcfg)
        t_from_j = tmc.decay(t_from_j, cfg=tcfg)
        assert_same(j_from_t, t_from_j, f"continued batch {i}")
    with pytest.raises(ValueError, match="do not match"):
        convert.state_from_numpy({"n_rows": leaves["n_rows"]}, tcfg, "cpu")
    bad = dict(leaves, **{"slabs.cnt": leaves["slabs.cnt"][:, :4]})
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(bad, tcfg, "cpu")


def test_functional_semantics_inputs_are_never_written():
    cfg = tmc.MCConfig(**CONFIGS["rolling"])
    state = tmc.init(cfg, device="cpu")
    for src, dst, weights, mask in _stream(seed=2, n_batches=6):
        before = convert.state_to_numpy(state)
        new = tmc.update_batch(state, src, dst, weights, mask, cfg=cfg)
        new = tmc.decay(new, cfg=cfg)
        tmc.query_threshold(state, src, 0.9, cfg=cfg)
        after = convert.state_to_numpy(state)
        for name in before:
            np.testing.assert_array_equal(before[name], after[name], err_msg=name)
        state = new


def test_pallas_interpret_state_equals_port_state():
    """The reference running its Pallas kernels (interpret mode) and the port
    agree leaf by leaf as well."""
    kw = dict(num_rows=16, capacity=8, max_probes=8, max_new_per_batch=8,
              decay_block_rows=8)
    jcfg, tcfg = jmc.MCConfig(impl="pallas", **kw), tmc.MCConfig(impl="auto", **kw)
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    g = MarkovGraphSampler(num_nodes=24, out_degree=10, seed=8)
    for i in range(6):
        src, dst = g.sample_transitions(32)
        jstate = jmc.update_batch(jstate, jnp.asarray(src), jnp.asarray(dst), cfg=jcfg)
        tstate = tmc.update_batch(tstate, src, dst, cfg=tcfg)
        jstate, tstate = jmc.decay(jstate, cfg=jcfg), tmc.decay(tstate, cfg=tcfg)
        assert_same(jstate, tstate, f"pallas batch {i}")
        assert_same(jmc.query_threshold(jstate, jnp.asarray(src), 0.9, cfg=jcfg),
                    tmc.query_threshold(tstate, src, 0.9, cfg=tcfg), f"pallas query {i}")


def test_public_names_match_the_reference_package():
    from repro import core as jcore
    for name in ("MCConfig", "MCState", "init", "update_batch", "query_threshold",
                 "query_topk", "decay", "maybe_decay", "update_batch_reference"):
        assert hasattr(jcore, name) and hasattr(tcore, name), name
    for name in ("check_invariants", "counter_stats", "maintenance_stats",
                 "EMPTY", "TOMB"):
        assert hasattr(tcore, name), name
    assert (tcore.EMPTY, tcore.TOMB) == (jmc.EMPTY, jmc.TOMB)
    assert jmc.MCState._fields == tmc.MCState._fields
    jf = {f.name: f.default for f in dataclasses.fields(jmc.MCConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tmc.MCConfig)}
    assert jf == tf
    for method in ("resolved_table_size", "resolved_dst_table_size",
                   "resolved_decay_rows"):
        for kw in (dict(), dict(num_rows=300, capacity=33, decay_block_rows=7)):
            assert getattr(jmc.MCConfig(**kw), method)() == \
                getattr(tmc.MCConfig(**kw), method)()
    assert jmc.MCConfig(max_new_per_batch=5).resolved_max_new(9) == \
        tmc.MCConfig(max_new_per_batch=5).resolved_max_new(9) == 5
