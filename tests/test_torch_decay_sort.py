"""The fused decay of the port against the reference, on the CPU.

``kernels/ref.py::decay_sort_rows_ref`` computes the decay the way the CUDA
kernel ``csrc/decay_sort.cu`` decomposes it (halve, evict, reduce, then a
bitonic network on the unique keys (count descending, priority position
ascending)); it must equal the plain composition ``decay_sort_ref`` (C//2+1
odd-even passes) and the JAX ``ops.decay_sort`` under ``impl="ref"`` and the
Pallas kernel in interpret mode, bit for bit.  Rolling ``decay`` finds its
block from the cursor without reading it on the host, and every leaf of the
state, ``decay_cursor`` included, equals the JAX package's after each call.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

from torch_parity import assert_same, jax_state_leaves, to_torch

CAPACITIES = [1, 2, 3, 5, 16, 33, 64, 128]


def _rows(rng, c):
    """Rows of every kind the sort must get right, in one batch: random
    counts, heavy ties, an all-zero row, counts of 1 (halved to 0: every
    edge evicted), odd counts just above the eviction line, counts up to
    2^31 - 1, free slots among live ones; each row twice, its
    ``order`` a random permutation and the order its counts already have."""
    cnt = np.stack([
        rng.integers(0, 1000, c),
        rng.integers(0, 4, c) * 2 + 2,             # ties after halving
        np.full(c, 6),                             # one tie over the row
        np.zeros(c, int),                          # all zero
        np.ones(c, int),                           # everything evicted
        rng.integers(1, 4, c),                     # 1 -> 0, 2 and 3 -> 1
        rng.integers(0, 2 ** 31 - 1, c),           # large counts
        rng.integers(0, 50, c) * (rng.random(c) < 0.5),
    ]).astype(np.int32)
    n = cnt.shape[0]
    dst = np.where(cnt > 0, rng.integers(0, 10_000, (n, c)), -1).astype(np.int32)
    order = np.concatenate([
        np.stack([rng.permutation(c) for _ in range(n)]),
        np.argsort(-cnt, axis=1, kind="stable")]).astype(np.int32)
    return np.concatenate([cnt, cnt]), np.concatenate([dst, dst]), order


@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
@pytest.mark.parametrize("c", CAPACITIES)
def test_decay_sort_decomposition_equals_the_composition_and_jax(jax_impl, c):
    cnt, dst, order = _rows(np.random.default_rng(c), c)
    want = jops.decay_sort(*(jnp.asarray(x) for x in (cnt, dst, order)),
                           impl=jax_impl)
    args = to_torch([cnt, dst, order])
    assert_same(want, ref.decay_sort_rows_ref(*args),
                f"decay_sort_rows_ref C={c} [jax {jax_impl}]")
    assert_same(want, ref.decay_sort_ref(*args), f"decay_sort_ref C={c}")
    for timpl in ("auto", "ref"):
        assert_same(want, tops.decay_sort(*args, impl=timpl),
                    f"ops.decay_sort C={c} [torch {timpl}]")


@settings(max_examples=60, deadline=None)
@given(c=st.integers(1, 300), n=st.integers(1, 6), hi=st.sampled_from([2, 5, 2 ** 31 - 1]),
       seed=st.integers(0, 2 ** 32 - 1))
def test_decay_sort_decomposition_property(c, n, hi, seed):
    """Over random rows: the kernel's decomposition equals the composition,
    and the new order is the stable descending sort of the halved counts in
    priority order."""
    rng = np.random.default_rng(seed)
    cnt = torch.from_numpy(rng.integers(0, hi, (n, c)).astype(np.int32))
    dst = torch.from_numpy(rng.integers(-1, 99, (n, c)).astype(np.int32))
    order = torch.from_numpy(
        np.stack([rng.permutation(c) for _ in range(n)]).astype(np.int32))
    got = ref.decay_sort_rows_ref(cnt, dst, order)
    assert_same(ref.decay_sort_ref(cnt, dst, order), got, f"C={c}")
    by_count = torch.sort(torch.gather(cnt >> 1, 1, order.long()), dim=1,
                          descending=True, stable=True).indices
    assert torch.equal(got[2], torch.gather(order, 1, by_count))


@pytest.mark.parametrize("n,r,cursor", [
    (48, 20, 0),       # three blocks, the last clamped to rows 28..48
    (37, 10, 3),       # starts at the clamped last block
    (37, 10, 9),       # starts past it: the cursor wraps
    (12, 5, 0),
])
def test_rolling_decay_stream_equals_jax_after_every_call(monkeypatch, n, r,
                                                          cursor):
    kw = dict(num_rows=n, capacity=8, decay_block_rows=r, impl="ref")
    jcfg, tcfg = jmc.MCConfig(**kw), tmc.MCConfig(**kw)
    rng = np.random.default_rng(n * r + cursor)
    jstate = jmc.init(jcfg)
    cnt = (rng.integers(0, 40, (n, 8)) * (rng.random((n, 8)) < 0.8)).astype(np.int32)
    dst = np.where(cnt > 0, rng.integers(0, 500, (n, 8)), -1).astype(np.int32)
    jstate = jstate._replace(
        slabs=jmc.Slabs(dst=jnp.asarray(dst), cnt=jnp.asarray(cnt),
                        tot=jnp.asarray(cnt.sum(axis=1).astype(np.int32)),
                        order=jnp.asarray(np.argsort(-cnt, axis=1, kind="stable")
                                          .astype(np.int32))),
        decay_cursor=jnp.int32(cursor))
    tstate = convert.state_from_numpy(jax_state_leaves(jstate), tcfg, device="cpu")
    assert_same(jstate, tstate, "start")

    def no_host_read(*_a, **_k):
        raise AssertionError("rolling decay read a tensor on the host")

    for call in range(2 * -(-n // r) + 1):
        jstate = jmc.decay(jstate, cfg=jcfg)
        with monkeypatch.context() as m:
            for name in ("__int__", "__bool__", "__index__", "item", "tolist"):
                m.setattr(torch.Tensor, name, no_host_read)
            new = tmc.decay(tstate, cfg=tcfg)
        for held, leaf in zip(tstate.slabs, new.slabs):
            assert held is not leaf      # the state given is never written
        tstate = new
        assert_same(jstate, tstate, f"n={n} r={r} decay call {call}")
