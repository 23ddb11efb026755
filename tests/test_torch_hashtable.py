"""Parity of repro_torch.core.hashtable with repro.core.hashtable (CPU,
tolerance zero): same numpy inputs through both, every output equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import hashtable as jht
from repro_torch.core import hashtable as tht

from torch_parity import assert_same, check

EDGE_KEYS = np.array([0, 1, 2, 2**31 - 1, 2**31 - 2, 65535, 65536, 0x7FEB352D],
                     np.int32)


def _hash_u32_np(x):
    x = x.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_hash_u32_matches_reference_and_numpy(seed):
    keys = EDGE_KEYS if seed is None else np.random.default_rng(seed).integers(
        0, 2**31 - 1, 4096).astype(np.int32)
    _, got = check(jht.hash_u32, tht.hash_u32, keys)
    with np.errstate(over="ignore"):
        want = _hash_u32_np(keys)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("width", [1, 2, 3, 5])
def test_ctx_window_hash_matches_reference(width):
    rng = np.random.default_rng(width)
    window = rng.integers(0, 2**31 - 1, (64, width)).astype(np.int32)
    window[0, :] = 0
    window[1, :] = 2**31 - 1
    check(jht.ctx_window_hash, tht.ctx_window_hash, window)
    h = rng.integers(0, 2**32 - 1, 64, dtype=np.uint32)
    want = jht.ctx_hash_fold(jnp.asarray(h), jnp.asarray(window[:, 0]))
    got = tht.ctx_hash_fold(torch.from_numpy(h.astype(np.int64)),
                            torch.from_numpy(window[:, 0]))
    assert_same(want, got, "ctx_hash_fold")


def _tables(size):
    return jht.make(size), tht.make(size, device="cpu")


def _script(rng, n_ops, key_range):
    ops = rng.choice(["insert", "delete", "lookup"], size=n_ops, p=[.5, .3, .2])
    keys = rng.integers(0, key_range, n_ops).astype(np.int32)
    vals = rng.integers(0, 1000, n_ops).astype(np.int32)
    return list(zip(ops, keys, vals))


def _apply(mod, table, op, key, val, max_probes, as_scalar):
    if op == "insert":
        table, slot, ok = mod.insert(table, as_scalar(key), as_scalar(val),
                                     max_probes)
        return table, (slot, ok)
    if op == "delete":
        table, ok = mod.delete(table, as_scalar(key), max_probes)
        return table, (ok,)
    return table, mod.lookup(table, as_scalar(key), max_probes)


@pytest.mark.parametrize("size,max_probes,key_range,seed", [
    (64, 64, 40, 0),      # roomy table
    (16, 8, 64, 1),       # full table, short window: drops
    (8, 16, 12, 2),       # window wraps the table twice
    (32, 4, 200, 3),      # tombstone-saturated windows
])
def test_scripted_insert_delete_lookup(size, max_probes, key_range, seed):
    rng = np.random.default_rng(seed)
    jt, tt = _tables(size)
    for step, (op, key, val) in enumerate(_script(rng, 120, key_range)):
        jt, jout = _apply(jht, jt, op, key, val, max_probes, jnp.int32)
        tt, tout = _apply(tht, tt, op, key, val, max_probes, int)
        assert_same(jout, tout, f"step {step} {op}({key}) result")
        assert_same(jt, tt, f"step {step} {op}({key}) table")
    probe = np.arange(key_range, dtype=np.int32)
    for impl in ("vmap", "ref"):
        assert_same(jht.lookup_batch(jt, jnp.asarray(probe), max_probes, impl=impl),
                    tht.lookup_batch(tt, probe, max_probes, impl=impl),
                    f"lookup_batch {impl}")
    assert_same(jht.load_factor(jt), tht.load_factor(tt), "load_factor")


def test_tombstone_saturated_window_reuses_first_tomb():
    size, max_probes = 16, 4
    jt, tt = _tables(size)
    # fill the whole table, then delete everything: every window is all TOMB
    keys = np.arange(100, 100 + 4 * size, dtype=np.int32)
    for k in keys:
        jt, _, _ = jht.insert(jt, jnp.int32(k), jnp.int32(k), size)
        tt, _, _ = tht.insert(tt, int(k), int(k), size)
    assert_same(jt, tt, "full table")
    assert int((tt.keys >= 0).sum()) == size
    for k in np.asarray(jt.keys):
        jt, _ = jht.delete(jt, jnp.int32(k), size)
        tt, _ = tht.delete(tt, int(k), size)
    assert_same(jt, tt, "all tombstones")
    assert bool((tt.keys == tht.TOMB).all())
    jt, jslot, jok = jht.insert(jt, jnp.int32(7), jnp.int32(1), max_probes)
    tt, tslot, tok = tht.insert(tt, 7, 1, max_probes)
    assert_same((jslot, jok), (tslot, tok), "insert into tombstones")
    assert bool(tok)
    assert_same(jt, tt, "table after tomb reuse")
    assert_same(jht.lookup(jt, jnp.int32(7), max_probes),
                tht.lookup(tt, 7, max_probes), "lookup after tomb reuse")


@pytest.mark.parametrize("size,max_probes", [(32, 32), (8, 4)])
def test_insert_batch_sequential(size, max_probes):
    rng = np.random.default_rng(size)
    keys = rng.integers(0, 24, 40).astype(np.int32)
    vals = rng.integers(0, 99, 40).astype(np.int32)
    active = rng.random(40) < 0.8
    jt, tt = _tables(size)
    want = jht.insert_batch_sequential(jt, jnp.asarray(keys), jnp.asarray(vals),
                                       jnp.asarray(active), max_probes)
    got = tht.insert_batch_sequential(tt, keys, vals, active, max_probes)
    assert_same(want, got, "insert_batch_sequential")


def test_make_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tht.make(12, device="cpu")
