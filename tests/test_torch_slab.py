"""Parity of repro_torch.core.slab with repro.core.slab (CPU, tolerance
zero)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import slab as jsl
from repro_torch.core import slab as tsl

from torch_parity import assert_same, check

SHAPES = [(8, 16), (7, 5), (4, 1), (16, 33), (3, 2)]


def _rand_slabs(rng, n, c, density=0.7, ties=False):
    hi = 4 if ties else 1000
    cnt = ((rng.random((n, c)) < density) * rng.integers(1, hi, (n, c))).astype(np.int32)
    dst = np.where(cnt > 0, rng.integers(0, 50, (n, c)), -1).astype(np.int32)
    tot = cnt.sum(axis=1).astype(np.int32)
    order = np.stack([rng.permutation(c) for _ in range(n)]).astype(np.int32)
    return dst, cnt, tot, order


def _both(arrs):
    j = jsl.Slabs(*(jnp.asarray(a) for a in arrs))
    t = tsl.Slabs(*(torch.from_numpy(a.copy()) for a in arrs))
    return j, t


@pytest.mark.parametrize("n,c", SHAPES)
def test_make(n, c):
    assert_same(jsl.make(n, c), tsl.make(n, c, device="cpu"), "make")


@pytest.mark.parametrize("n,c", SHAPES)
@pytest.mark.parametrize("passes", [0, 1, 3])
def test_oddeven_passes(n, c, passes):
    rng = np.random.default_rng(n * 100 + c + passes)
    _, cnt, _, order = _rand_slabs(rng, n, c, ties=True)
    check(jsl.oddeven_passes, tsl.oddeven_passes, cnt, order, passes=passes)


@pytest.mark.parametrize("n,c", SHAPES)
def test_full_sort_with_ties_inversions_sorted_fraction(n, c):
    rng = np.random.default_rng(n + c)
    _, cnt, _, order = _rand_slabs(rng, n, c, ties=True)
    check(jsl.full_sort, tsl.full_sort, cnt, order)
    check(jsl.inversions, tsl.inversions, cnt, order)
    if c > 1:
        check(jsl.sorted_fraction, tsl.sorted_fraction, cnt, order)


@pytest.mark.parametrize("n,c", SHAPES)
def test_find_free_tail_slot(n, c):
    rng = np.random.default_rng(n * 7 + c)
    arrs = _rand_slabs(rng, n, c, density=0.6)
    arrs[0][0, :] = np.where(arrs[1][0] > 0, 9, -1)   # duplicate dsts: lowest wins
    arrs[1][-1, :] = np.maximum(arrs[1][-1], 1)       # a full row: no free slot
    js, ts = _both(arrs)
    for row in range(n):
        for dst in (9, int(arrs[0][row, c // 2]), 12345):
            assert_same(jsl.find_slot(js, jnp.int32(row), jnp.int32(dst)),
                        tsl.find_slot(ts, row, dst), f"find_slot {row},{dst}")
        assert_same(jsl.free_slot(js, jnp.int32(row)), tsl.free_slot(ts, row),
                    f"free_slot {row}")
        assert_same(jsl.tail_slot(js, jnp.int32(row)), tsl.tail_slot(ts, row),
                    f"tail_slot {row}")


@pytest.mark.parametrize("n,c", SHAPES)
def test_decay(n, c):
    rng = np.random.default_rng(n * 13 + c)
    js, ts = _both(_rand_slabs(rng, n, c, ties=True))
    for step in range(3):
        (js, jev), (ts, tev) = jsl.decay(js), tsl.decay(ts)
        assert_same((js, jev), (ts, tev), f"decay step {step}")
