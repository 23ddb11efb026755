"""Each plain PyTorch kernel version of repro_torch.kernels against the JAX
oracle (impl='ref') AND the JAX Pallas kernel in interpret mode
(impl='pallas'), same numpy inputs, tolerance zero.  On the CPU the port's
ops dispatch to these plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.kernels import ops as tops

from torch_parity import assert_same, jax_state_leaves, to_jax, to_torch

JAX_IMPLS = ["ref", "pallas"]


def _rand_slabs(rng, n, c, density=0.7):
    cnt = ((rng.random((n, c)) < density) * rng.integers(1, 1000, (n, c))).astype(np.int32)
    dst = np.where(cnt > 0, rng.integers(0, 10_000, (n, c)), -1).astype(np.int32)
    tot = cnt.sum(axis=1).astype(np.int32)
    order = np.argsort(-cnt, axis=1, kind="stable").astype(np.int32)
    return dst, cnt, tot, order


def _both_impls(name, jax_impl, *inputs, **static):
    """ops.<name> of both packages on the same inputs: JAX under ``jax_impl``
    (once), the port under 'auto' (CPU tensors -> plain version) and 'ref'."""
    want = getattr(jops, name)(*to_jax(list(inputs)), impl=jax_impl, **static)
    for timpl in ("auto", "ref"):
        got = getattr(tops, name)(*to_torch(list(inputs)), impl=timpl, **static)
        assert_same(want, got, f"{name}[jax {jax_impl} / torch {timpl}]")


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("n,c", [(8, 16), (7, 5), (5, 1), (16, 33)])
@pytest.mark.parametrize("passes", [1, 2, 5])
def test_oddeven_sort(jax_impl, n, c, passes):
    rng = np.random.default_rng(n * 1000 + c + passes)
    cnt = rng.integers(0, 6, (n, c)).astype(np.int32)
    order = np.stack([rng.permutation(c) for _ in range(n)]).astype(np.int32)
    _both_impls("oddeven_sort", jax_impl, cnt, order, passes=passes)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("n,c,batch", [(8, 16, 32), (7, 5, 19), (32, 8, 64)])
def test_slab_update(jax_impl, n, c, batch):
    rng = np.random.default_rng(n + c + batch)
    dst, cnt, tot, _ = _rand_slabs(rng, n, c)
    dst[0, :] = np.where(cnt[0] > 0, 77, -1)             # duplicate dsts: first slot
    rows = rng.integers(-1, n, batch).astype(np.int32)   # -1 = padding
    pick = rng.integers(0, c, batch)
    dsts = dst[np.maximum(rows, 0), pick]
    absent = rng.random(batch) < 0.25
    dsts = np.where(absent, 54321, dsts).astype(np.int32)
    rows[:4], dsts[:4] = rows[4:8], dsts[4:8]            # duplicate items add up
    w = rng.integers(1, 9, batch).astype(np.int32)
    _both_impls("slab_update", jax_impl, rows, dsts, w, dst, cnt, tot)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("n,c", [(8, 16), (6, 5), (4, 1)])
def test_decay_sort(jax_impl, n, c):
    rng = np.random.default_rng(n * 3 + c)
    dst, cnt, _, order = _rand_slabs(rng, n, c)
    cnt = np.minimum(cnt, rng.integers(1, 5, (n, c))).astype(np.int32) * (cnt > 0)
    _both_impls("decay_sort", jax_impl, cnt.astype(np.int32), dst, order)


def _dh_tables(rng, n, h, max_probes, fill, delete_frac):
    """Per-row tables built with the port's own insert/delete, so chains hold
    tombstones and wrap around the end of a small table."""
    from repro_torch.core import hashtable as tht
    keys = np.full((n, h), -1, np.int32)
    vals = np.full((n, h), -1, np.int32)
    members = []
    for r in range(n):
        tab = tht.make(h, device="cpu")
        ks = rng.choice(500, size=fill, replace=False).astype(np.int32)
        for i, k in enumerate(ks):
            tab, _, _ = tht.insert(tab, int(k), i, max_probes)
        for k in ks[rng.random(fill) < delete_frac]:
            tab, _ = tht.delete(tab, int(k), max_probes)
        keys[r], vals[r] = tab.keys.numpy(), tab.vals.numpy()
        members.append(ks)
    return keys, vals, members


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("n,h,max_probes,fill,delete_frac", [
    (4, 32, 32, 12, 0.0),
    (3, 16, 8, 14, 0.5),     # tombstone chains, short window
    (2, 8, 16, 7, 0.4),      # window wraps the table
    (5, 64, 4, 40, 0.9),     # tombstone-saturated windows
    (3, 16, 1, 10, 0.3),     # the home slot alone
])
def test_dh_find_and_ht_find(jax_impl, n, h, max_probes, fill, delete_frac):
    rng = np.random.default_rng(n * h + max_probes)
    keys, vals, members = _dh_tables(rng, n, h, max_probes, fill, delete_frac)
    batch = 48
    rows = rng.integers(-1, n, batch).astype(np.int32)    # -1 = padding
    q = np.array([rng.choice(members[max(r, 0)]) for r in rows], np.int32)
    q = np.where(rng.random(batch) < 0.3, rng.integers(0, 600, batch), q).astype(np.int32)
    q[::7] = -1                                           # the EMPTY key: a miss
    _both_impls("dh_find", jax_impl, rows, q, keys, vals, max_probes=max_probes)
    _both_impls("ht_find", jax_impl, q, keys[0], vals[0], max_probes=max_probes)
    # the miss value lookup_rows asks for: the port's one kernel output
    # against the reference's lookup and its where
    want_v, want_f = jops.ht_find(*to_jax([q, keys[0], vals[0]]),
                                  max_probes=max_probes, impl=jax_impl)
    for timpl in ("auto", "ref"):
        got = tops.ht_find(*to_torch([q, keys[0], vals[0]]),
                           max_probes=max_probes, miss=0, impl=timpl)
        assert_same((jnp.where(want_f, want_v, 0), want_f), got,
                    f"ht_find miss=0 [jax {jax_impl} / torch {timpl}]")


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("n,c,max_items", [(16, 128, 16), (9, 5, 8), (8, 256, 4), (4, 1, 2),
                                         (6, 300, 20)])   # wider than one step
def test_cdf_query_fused(jax_impl, n, c, max_items):
    rng = np.random.default_rng(n + c)
    dst, cnt, tot, order = _rand_slabs(rng, n, c, density=0.5)
    cnt[1, :] = 0                                        # a known but empty row
    dst[1, :] = -1
    tot[1] = 0
    batch = 24
    rows = rng.integers(0, n, batch).astype(np.int32)
    found = rng.random(batch) < 0.8                      # unknown srcs
    rows = np.where(found, rows, 0).astype(np.int32)
    for threshold in (0.0, 0.5, 0.9, 1.0, None):
        # every chunking at one threshold and in top-k mode, auto elsewhere
        chunk_choices = (0, 1, 2, 4) if threshold in (0.5, None) else (0,)
        for chunks in chunk_choices:
            if chunks and c % chunks:
                continue
            _both_impls("cdf_query_fused", jax_impl, rows, found, cnt, dst,
                        order, tot, threshold=threshold, max_items=max_items,
                        chunks=chunks)
    # topk=True with a threshold given is top-k mode as well
    _both_impls("cdf_query_fused", jax_impl, rows, found, cnt, dst, order, tot,
                threshold=0.5, max_items=max_items, topk=True)


@pytest.mark.parametrize("timpl", ["auto", "ref"])
def test_cdf_query_fused_takes_found_as_bool_unchanged(timpl):
    """``ops.cdf_query_fused`` hands ``found`` on as the bool mask that
    ``lookup_rows`` returns (no cast); on CPU tensors the answers are JAX's
    and those an int32 mask gives."""
    rng = np.random.default_rng(11)
    dst, cnt, tot, order = _rand_slabs(rng, 12, 40, density=0.6)
    rows = rng.integers(0, 12, 30).astype(np.int32)
    found = rng.random(30) < 0.7
    for threshold, k in ((0.8, 6), (None, 50)):
        want = jops.cdf_query_fused(*to_jax([rows, found, cnt, dst, order, tot]),
                                    threshold, max_items=k, impl="ref")
        args = to_torch([rows, found, cnt, dst, order, tot])
        assert args[1].dtype == torch.bool
        got = tops.cdf_query_fused(*args, threshold, max_items=k, impl=timpl)
        assert_same(want, got, f"bool found t={threshold} [torch {timpl}]")
        as_int = tops.cdf_query_fused(args[0], args[1].to(torch.int32), *args[2:],
                                      threshold, max_items=k, impl=timpl)
        assert_same(got, as_int, f"int32 found t={threshold} [torch {timpl}]")


def test_cdf_query_fused_chunkings_identical_and_bad_chunks_raise():
    rng = np.random.default_rng(5)
    dst, cnt, tot, order = _rand_slabs(rng, 8, 16)
    args = [torch.from_numpy(x) for x in
            (np.arange(8, dtype=np.int32), np.ones(8, bool), cnt, dst, order, tot)]
    base = tops.cdf_query_fused(*args, 0.7, max_items=6, chunks=0)
    for chunks in (1, 2, 4, 8, 16):
        assert_same(base, tops.cdf_query_fused(*args, 0.7, max_items=6,
                                               chunks=chunks), f"chunks={chunks}")
    for bad in (3, 5, 32):
        with pytest.raises(ValueError, match="must divide capacity"):
            tops.cdf_query_fused(*args, 0.7, max_items=6, chunks=bad)
        with pytest.raises(ValueError, match="must divide capacity"):
            jops.cdf_query_fused(*(jnp.asarray(a.numpy()) for a in args), 0.7,
                                 max_items=6, chunks=bad, impl="ref")


@pytest.mark.parametrize("impl", ["pallas", "triton", "", "CUDA"])
def test_unknown_impl_raises_value_error(impl):
    x = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.oddeven_sort(x, x, impl=impl)


def test_impl_cuda_on_cpu_tensors_raises():
    x = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.oddeven_sort(x, x, impl="cuda")


# ---------------------------------------------------------------------------
# slow path: against the reference's lax.scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_rows,capacity,table_size,max_probes,seed", [
    (16, 4, 0, 64, 0),     # rows and slots run out: dropped_rows, evictions
    (64, 8, 16, 2, 1),     # tiny table, short window: dropped_probes
    (32, 3, 0, 8, 2),
])
def test_slow_path_matches_reference_scan(num_rows, capacity, table_size,
                                          max_probes, seed):
    rng = np.random.default_rng(seed)
    jcfg = jmc.MCConfig(num_rows=num_rows, capacity=capacity,
                        table_size=table_size, max_probes=max_probes,
                        impl="ref")
    tcfg = tmc.MCConfig(**dataclasses.asdict(jcfg))
    jstate = jmc.init(jcfg)
    tstate = tmc.init(tcfg, device="cpu")
    for step in range(4):
        n_items = 40
        src = rng.integers(0, 40, n_items).astype(np.int32)
        dst = rng.integers(0, 12, n_items).astype(np.int32)
        w = rng.integers(1, 5, n_items).astype(np.int32)
        active = rng.random(n_items) < 0.8
        jstate = jmc._slow_path(jstate, jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(w), jnp.asarray(active), jcfg)
        tstate = tmc._slow_path(tstate, torch.from_numpy(src),
                                torch.from_numpy(dst), torch.from_numpy(w),
                                torch.from_numpy(active), tcfg)
        assert_same(jstate, tstate, f"slow path step {step}")
        # order only changes in the sort: give both the same new order
        order = np.stack([rng.permutation(capacity) for _ in range(num_rows)]).astype(np.int32)
        jstate = jstate._replace(slabs=jstate.slabs._replace(order=jnp.asarray(order)))
        tstate = tstate._replace(slabs=tstate.slabs._replace(order=torch.from_numpy(order)))
    stats = tmc.counter_stats(tstate)
    assert stats["n_rows"] > 0
    if table_size:
        assert stats["dropped_probes"] > 0
    else:
        assert stats["dropped_rows"] > 0 and stats["evictions"] > 0
    # the state crosses between the packages unchanged
    assert_same(jstate, convert.state_from_numpy(jax_state_leaves(jstate), tcfg, "cpu"),
                "state_from_numpy")


# ---------------------------------------------------------------------------
# cdf_query over pre-ordered rows (the unfused read)
# ---------------------------------------------------------------------------


def _ordered_counts(rng, b, c, zero_frac, zipf=1.5):
    raw = np.sort(rng.zipf(zipf, (b, c)).astype(np.int32), axis=1)[:, ::-1]
    raw[rng.random((b, c)) < zero_frac] = 0
    raw = np.ascontiguousarray(np.sort(raw, axis=1)[:, ::-1])
    d_ord = rng.integers(0, 1000, (b, c)).astype(np.int32)
    return raw, d_ord, raw.sum(axis=1).astype(np.int32)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("b,c", [(8, 16), (128, 128), (64, 256)])
@pytest.mark.parametrize("t", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("chunks", [1, 4])
def test_cdf_query(jax_impl, b, c, t, chunks):
    rng = np.random.default_rng(b + int(t * 100) + chunks)
    c_ord, d_ord, tot = _ordered_counts(rng, b, c, 0.1)
    c_ord[0], tot[0] = 0, 0                              # an unknown src
    _both_impls("cdf_query", jax_impl, c_ord, d_ord, tot, threshold=t,
                max_items=16, chunks=chunks)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_cdf_query_topk_mode(jax_impl, chunks):
    rng = np.random.default_rng(chunks)
    c_ord, d_ord, tot = _ordered_counts(rng, 32, 64, 0.3)
    _both_impls("cdf_query", jax_impl, c_ord, d_ord, tot, threshold=None,
                max_items=8, chunks=chunks)
    _both_impls("cdf_query", jax_impl, c_ord, d_ord, tot, threshold=0.4,
                max_items=70, chunks=chunks, topk=True)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_cdf_query_empty_rows_and_quantile(jax_impl):
    zeros = np.zeros((4, 32), np.int32)
    _both_impls("cdf_query", jax_impl, zeros, zeros, np.zeros(4, np.int32),
                threshold=0.9, max_items=8)
    # cumsum/1024: .5 .75 .875 .9375 -> 4 items needed
    c_ord = np.asarray([[512, 256, 128, 64, 32, 16, 8, 8]], np.int32)
    d_ord = np.arange(8, dtype=np.int32)[None]
    tot = np.asarray([1024], np.int32)
    _both_impls("cdf_query", jax_impl, c_ord, d_ord, tot, threshold=0.9,
                max_items=8)
    _, _, n = tops.cdf_query(*to_torch([c_ord, d_ord, tot]), 0.9, max_items=8)
    assert int(n[0]) == 4


def test_cdf_query_bad_chunks_raise():
    x = torch.zeros((2, 16), dtype=torch.int32)
    for bad in (3, 5, 32):
        with pytest.raises(ValueError, match="must divide capacity"):
            tops.cdf_query(x, x, x[:, 0], 0.5, chunks=bad)


# ---------------------------------------------------------------------------
# draft walk
# ---------------------------------------------------------------------------


def _walk_chain(rng, order, table_size, n_tokens=64):
    """A chain learned (in JAX) from a noisy successor stream, a share of its
    src keys then tombstoned; returns the raw arrays and the token stream."""
    from repro.core import speculative as jspec
    from repro_torch.core import hashtable as tht

    ncfg = jspec.NGramConfig(order=order, mc=jmc.MCConfig(
        num_rows=48 if table_size else 256, capacity=8, sort_passes=2,
        table_size=table_size, max_probes=16))
    succ = rng.integers(0, n_tokens, (n_tokens,)).astype(np.int32)
    toks = np.empty((4, 128), np.int32)
    toks[:, 0] = rng.integers(0, n_tokens, 4)
    for i in range(1, 128):
        noise = rng.integers(0, n_tokens, 4)
        toks[:, i] = np.where(rng.random(4) < 0.9, succ[toks[:, i - 1]], noise)
    chain = jspec.observe(jspec.init(ncfg), jnp.asarray(toks), cfg=ncfg).chain
    table = tht.HashTable(*to_torch([np.asarray(chain.src_table.keys),
                                     np.asarray(chain.src_table.vals)]))
    live = table.keys[table.keys >= 0]
    for key in live[torch.from_numpy(rng.random(live.numel()) < 0.2)].tolist():
        table, _ = tht.delete(table, key, 16)
    assert bool((table.keys == -2).any())
    arrays = [table.keys.numpy(), table.vals.numpy(),
              np.asarray(chain.slabs.cnt), np.asarray(chain.slabs.dst),
              np.ascontiguousarray(np.asarray(chain.slabs.order)[:, 0])]
    return arrays, toks


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("order,k,table_size", [
    (2, 1, 0), (2, 4, 0), (2, 7, 0),
    (1, 4, 0),
    (3, 8, 64),      # small table: chains wrap its end
])
def test_draft_walk(jax_impl, order, k, table_size):
    rng = np.random.default_rng(order * 10 + k)
    arrays, toks = _walk_chain(rng, order, table_size)
    # learned contexts, contexts whose key was tombstoned, unknown contexts
    window = np.concatenate([toks[:, 50:50 + order], toks[:, 90:90 + order],
                             np.full((2, order), 7777, np.int32)]).astype(np.int32)
    _both_impls("draft_walk", jax_impl, window, *arrays, k=k, max_probes=16)
    toks_k, ok = tops.draft_walk(*to_torch([window, *arrays]), k=k, max_probes=16)
    assert ok.dtype == torch.bool and ok.any()
    assert not ok[-2:].any() and not toks_k[-2:].any()
    # ok rows are prefixes: once a lane dies it stays dead
    assert torch.equal(ok, torch.cumprod(ok.to(torch.int32), dim=1).to(torch.bool))


def test_draft_walk_reads_strided_views_and_empty_batches():
    rng = np.random.default_rng(3)
    arrays, toks = _walk_chain(rng, 2, 0)
    keys, vals, cnt, dst, _ = to_torch(arrays)
    order = torch.from_numpy(np.argsort(-arrays[2], axis=1, kind="stable")
                             .astype(np.int32))
    context = torch.from_numpy(toks[:, 40:48].copy())
    strided = tops.draft_walk(context[:, -2:], keys, vals, cnt, dst, order[:, 0], k=5)
    dense = tops.draft_walk(context[:, -2:].contiguous(), keys, vals, cnt, dst,
                            order[:, 0].contiguous(), k=5)
    assert_same(dense, strided, "strided views")
    toks0, ok0 = tops.draft_walk(context[:0, -2:], keys, vals, cnt, dst, order[:, 0], k=5)
    assert toks0.shape == ok0.shape == (0, 5)


# ---------------------------------------------------------------------------
# the cross-shard top-n merge: against the reference's lax.scan
# ---------------------------------------------------------------------------


def _merge_lists(rng, s, m, kind):
    """Per-shard lists of one kind: descending with ties within and across
    shards and dead tails, not descending, all zero, or with NaN and -0.0."""
    probs = rng.integers(0, 6, (s, m)).astype(np.float32) / 8
    if kind == "descending":
        probs = -np.sort(-probs, axis=1)
        probs[:, m // 2 + 1:] = 0.0                  # dead tails
    elif kind == "zeros":
        probs[:] = 0.0
    elif kind == "nan":
        probs[rng.random((s, m)) < 0.2] = np.nan
        probs[rng.random((s, m)) < 0.2] = -0.0
        probs[rng.random((s, m)) < 0.1] = -0.5
    dsts = np.where(probs > 0, rng.integers(0, 500, (s, m)), EMPTY_ID)
    srcs = np.where(probs > 0, rng.integers(0, 500, (s, m)), EMPTY_ID)
    return probs.astype(np.float32), dsts.astype(np.int32), srcs.astype(np.int32)


EMPTY_ID = -1


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("kind", ["descending", "unsorted", "zeros", "nan"])
@pytest.mark.parametrize("s,m,n", [(1, 1, 3), (1, 7, 4), (3, 5, 16), (4, 6, 8),
                                   (8, 3, 40), (5, 9, 9), (33, 5, 40),
                                   (40, 6, 24), (64, 3, 200), (64, 9, 17)])
def test_topn_merge(jax_impl, kind, s, m, n):
    """Every step of the head-pointer merge: S 1..8 and 33..64 (past one
    warp's 32 lists), ties (the lowest shard first), dead tails, lists that
    are not descending, NaN and -0.0 heads, n above M and above S·M
    (exhausted lists read 0)."""
    rng = np.random.default_rng(s * 100 + m * 10 + n)
    _both_impls("topn_merge", jax_impl, *_merge_lists(rng, s, m, kind), n=n)


@pytest.mark.parametrize("kind", ["descending", "unsorted", "zeros", "nan"])
@pytest.mark.parametrize("s,m,n", [(33, 5, 40), (40, 6, 24), (64, 3, 200),
                                   (64, 9, 17), (1100, 1, 30)])
def test_topn_merge_over_32_lists_in_rounds(kind, s, m, n):
    """Past one warp's 32 lists the kernel merges in rounds (groups of 32
    carrying their raw heads, then a merge of the groups); its plain mirror
    ``topn_merge_rounds_ref`` and ``topn_merge_ref`` both equal the
    reference's flat merge: ties, NaN, -0.0, zero and negative heads, one
    list shorter than n (every list is at these M), n past S·M, three rounds
    at 1,100 lists."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(s * 7 + m * 3 + n)
    probs, dsts, srcs = _merge_lists(rng, s, m, kind)
    if kind == "nan":
        probs[rng.random((s, m)) < 0.1] = -0.25
    want = jops.topn_merge(*to_jax([probs, dsts, srcs]), n=n, impl="ref")
    t = to_torch([probs, dsts, srcs])
    assert_same(want, ref.topn_merge_ref(*t, n), "topn_merge_ref")
    assert_same(want, ref.topn_merge_rounds_ref(*t, n), "rounds")
    assert_same(want, tops.topn_merge(*t, n=n), "ops.topn_merge on the CPU")
