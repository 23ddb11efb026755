"""The first slice of the port as a whole: repro_torch.core.mcprioq against
repro.core.mcprioq on the CPU.  The same seeded stream goes through both;
after EVERY batch all 18 MCState leaves and the query answers are equal
(tolerance zero, int32 and float32 alike)."""

import dataclasses
import functools
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro_torch import convert
from repro_torch.core import mcprioq as tmc

from torch_parity import (CHAIN_CONFIGS as CONFIGS, assert_same,
                          jax_state_leaves,
                          chain_configs as _configs, chain_stream as _stream,
                          opt as _opt)


def _queries(jstate, tstate, jcfg, tcfg, srcs, what):
    for t, k in ((0.5, 4), (0.9, 16), (1.0, 3)):
        assert_same(
            jmc.query_threshold(jstate, jnp.asarray(srcs), t, cfg=jcfg, max_items=k),
            tmc.query_threshold(tstate, srcs, t, cfg=tcfg, max_items=k),
            f"{what} query_threshold t={t} k={k}")
    assert_same(jmc.query_topk(jstate, jnp.asarray(srcs), cfg=jcfg, k=5),
                tmc.query_topk(tstate, srcs, cfg=tcfg, k=5), f"{what} query_topk")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_state_and_answers_equal_after_every_batch(name):
    jcfg, tcfg = _configs(name)
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    assert_same(jstate, tstate, "init")
    assert len(convert.state_to_numpy(tstate)) == 18
    probe = np.arange(-2, 70, dtype=np.int32)
    jax_maybe_decay = jax.jit(functools.partial(
        jmc.maybe_decay, cfg=jcfg, total_threshold=40))
    for i, (src, dst, weights, mask) in enumerate(_stream(seed=len(name))):
        jstate = jmc.update_batch(jstate, jnp.asarray(src), jnp.asarray(dst),
                                  _opt(weights, jnp.asarray), _opt(mask, jnp.asarray),
                                  cfg=jcfg)
        tstate = tmc.update_batch(tstate, src, dst, weights, mask, cfg=tcfg)
        assert_same(jstate, tstate, f"{name} batch {i} update_batch")
        jstate = jax_maybe_decay(jstate)
        tstate = tmc.maybe_decay(tstate, cfg=tcfg, total_threshold=40)
        if i in (20, 21, 22, 35):      # explicit decays: walks the cursor
            jstate, tstate = jmc.decay(jstate, cfg=jcfg), tmc.decay(tstate, cfg=tcfg)
        assert_same(jstate, tstate, f"{name} batch {i} decay")
        _queries(jstate, tstate, jcfg, tcfg, probe, f"{name} batch {i}")
    stats = tmc.counter_stats(tstate)
    assert stats == jmc.counter_stats(jstate)
    assert tmc.maintenance_stats(tstate) == jmc.maintenance_stats(jstate)
    assert stats["dropped_rows"] > 0 and stats["evictions"] > 0
    assert stats["decay_steps"] > 4
    if tcfg.max_new_per_batch:
        assert stats["deferred_new"] > 0
    jinv, tinv = jmc.check_invariants(jstate, jcfg), tmc.check_invariants(tstate, tcfg)
    assert jinv == tinv
    assert all(v for k, v in tinv.items() if k != "sorted_fraction")


@pytest.mark.parametrize("chunks", [0, 1, 2])
def test_unfused_queries_equal_jax_and_the_fused_path(chunks):
    """fused_query=False (``_ordered_rows`` + ``ops.cdf_query``) against the
    reference's unfused read and against the port's fused read."""
    jcfg, tcfg = _configs("rolling")
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    for src, dst, weights, mask in itertools.islice(_stream(seed=chunks), 12):
        jstate = jmc.update_batch(jstate, jnp.asarray(src), jnp.asarray(dst),
                                  _opt(weights, jnp.asarray), _opt(mask, jnp.asarray),
                                  cfg=jcfg)
        tstate = tmc.update_batch(tstate, src, dst, weights, mask, cfg=tcfg)
    assert_same(jstate, tstate, "stream")
    jun = dataclasses.replace(jcfg, fused_query=False, query_chunks=chunks)
    tun = dataclasses.replace(tcfg, fused_query=False, query_chunks=chunks)
    srcs = np.arange(-2, 70, dtype=np.int32)
    _queries(jstate, tstate, jun, tun, srcs, f"unfused chunks={chunks}")
    for t, k in ((0.9, 16), (None, 5)):
        fused = tmc.query_impl(tstate, srcs, t, tcfg, k)
        assert_same(fused, tmc.query_impl(tstate, srcs, t, tun, k),
                    f"unfused vs fused t={t}")


def test_fused_query_false_is_accepted():
    assert not tmc.MCConfig(fused_query=False).fused_query


@pytest.mark.parametrize("name", ["rolling", "no_sort_small_table"])
def test_lookup_rows_equals_jax_found_and_missing(name):
    """The port's lookup_rows (one flat-mode probe writing row 0 for a
    missing src) against the reference's on the same learned state: known
    srcs, unknown ones, negative ids and the EMPTY key -1."""
    jcfg, tcfg = _configs(name)
    jstate = jmc.init(jcfg)
    for src, dst, weights, mask in itertools.islice(_stream(seed=3), 8):
        jstate = jmc.update_batch(jstate, jnp.asarray(src), jnp.asarray(dst),
                                  _opt(weights, jnp.asarray), _opt(mask, jnp.asarray),
                                  cfg=jcfg)
    tstate = convert.state_from_numpy(jax_state_leaves(jstate), tcfg,
                                      device="cpu")
    srcs = np.concatenate([np.arange(-3, 90), [-1, 2**30, 7, -1]]).astype(np.int32)
    for jimpl in ("ref", "pallas"):
        want = jmc.lookup_rows(jstate, jnp.asarray(srcs),
                               cfg=dataclasses.replace(jcfg, impl=jimpl))
        for timpl in ("auto", "ref"):
            got = tmc.lookup_rows(tstate, srcs, dataclasses.replace(tcfg, impl=timpl))
            assert_same(want, got, f"lookup_rows [jax {jimpl} / torch {timpl}]")
    found = np.asarray(want[1])
    assert found.any() and not found.all()
    assert not found[srcs == -1].any()
