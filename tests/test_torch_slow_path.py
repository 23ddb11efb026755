"""The new-edge pass, decomposed as the CUDA kernel computes it.

``csrc/slow_path.cu`` does not walk the items in order: it looks every src
up at once, walks only the misses in order, then gives each row to its own
warp.  ``kernels/ref.py::slow_path_rows_ref`` is the plain mirror of that
decomposition.  Here it is held equal (tolerance 0, all six outputs) to the
sequential plain version ``slow_path_ref`` and to the reference's
``lax.scan`` (``repro.core.mcprioq._slow_path``) on the cases where the
order of the items matters, and on random small tables.  Also the contract
of the pass's two forms (functional: nothing written; in place: exactly what
the pass writes, with the rows it writes flagged) and that ``update_batch``
hands the pass copies, never the state's tensors."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro_torch import convert
from repro_torch.core import hashtable as tht
from repro_torch.core import mcprioq as tmc
from repro_torch.kernels import ops, ref

from torch_parity import assert_same

N, C, H, P = 16, 4, 32, 4      # rows, slots per row, src table slots, window
L = 48                         # items of a pass (padded with inactive items)
SORT_TILE = 8192               # keys the kernel sorts in one block
JCFG = jmc.MCConfig(num_rows=N, capacity=C, table_size=H, max_probes=P,
                    impl="ref")
_jax_pass = jax.jit(jmc._slow_path, static_argnames="cfg")
NAMES = ("tab_keys", "tab_vals", "dst_slab", "cnt", "tot", "order",
         "counters", "src", "dst", "w", "active")


def _home(key):
    return int(tht.hash_u32(torch.tensor(key)) & (H - 1))


def _keys_at_home(slot, count, start=1000):
    """``count`` keys from ``start`` on whose home slot is ``slot``."""
    out, key = [], start
    while len(out) < count:
        if _home(key) == slot:
            out.append(key)
        key += 1
    return out


def _state(rng, srcs=(), n_rows=None):
    """A pass's state: the src table holding ``srcs[r] -> r`` (inserted in
    order, as the pass would), random slabs, counters."""
    table = tht.make(H, device="cpu")
    k = torch.tensor(list(srcs), dtype=torch.int32)
    table, _, _ = tht.insert_batch_sequential(
        table, k, torch.arange(len(k)), torch.ones(len(k), dtype=torch.bool), P)
    cnt = ((rng.random((N, C)) < 0.6) * rng.integers(1, 9, (N, C))).astype(np.int32)
    return {
        "tab_keys": table.keys.numpy(), "tab_vals": table.vals.numpy(),
        "dst_slab": np.where(cnt > 0, rng.integers(0, 12, (N, C)), -1).astype(np.int32),
        "cnt": cnt, "tot": cnt.sum(axis=1).astype(np.int32),
        "order": np.stack([rng.permutation(C) for _ in range(N)]).astype(np.int32),
        "counters": np.array([len(srcs) if n_rows is None else n_rows, 0, 0, 0],
                             np.int32),
    }


def _items(src, dst=None, w=None, active=None, rng=None, length=L):
    """Items padded to ``length`` with inactive ones."""
    rng = rng or np.random.default_rng(0)
    n = len(src)
    pad = np.zeros(length - n, np.int32)
    dst = rng.integers(0, 12, n) if dst is None else dst
    w = rng.integers(1, 5, n) if w is None else w
    active = np.ones(n, bool) if active is None else active
    return {"src": np.concatenate([np.asarray(src, np.int32), pad]),
            "dst": np.concatenate([np.asarray(dst, np.int32), pad]),
            "w": np.concatenate([np.asarray(w, np.int32), pad + 1]),
            "active": np.concatenate([np.asarray(active, bool),
                                      np.zeros(length - n, bool)])}


def _jax(case):
    s = jmc.init(JCFG)
    ctr = case["counters"]
    s = s._replace(
        src_table=s.src_table._replace(keys=jnp.asarray(case["tab_keys"]),
                                       vals=jnp.asarray(case["tab_vals"])),
        slabs=s.slabs._replace(dst=jnp.asarray(case["dst_slab"]),
                               cnt=jnp.asarray(case["cnt"]),
                               tot=jnp.asarray(case["tot"]),
                               order=jnp.asarray(case["order"])),
        n_rows=jnp.int32(ctr[0]), dropped_rows=jnp.int32(ctr[1]),
        dropped_probes=jnp.int32(ctr[2]), evictions=jnp.int32(ctr[3]))
    s = _jax_pass(s, *(jnp.asarray(case[k]) for k in ("src", "dst", "w", "active")),
                  cfg=JCFG)
    return (s.src_table.keys, s.src_table.vals, s.slabs.dst, s.slabs.cnt,
            s.slabs.tot, np.array([s.n_rows, s.dropped_rows, s.dropped_probes,
                                   s.evictions], np.int32))


def _torch_args(case):
    return [torch.from_numpy(np.array(case[k])) for k in NAMES]


def check_pass(case):
    """The reference's scan, the sequential plain version and the plain
    mirror of the kernel's decomposition give the same six outputs; returns
    the counters."""
    want = _jax(case)
    assert_same(want, ref.slow_path_ref(*_torch_args(case), P), "slow_path_ref")
    assert_same(want, ref.slow_path_rows_ref(*_torch_args(case), P),
                "slow_path_rows_ref")
    return dict(zip(("n_rows", "dropped_rows", "dropped_probes", "evictions"),
                    want[5].tolist()))


# ---------------------------------------------------------------------------
# the cases where the order of the items matters
# ---------------------------------------------------------------------------


def test_rows_run_out_mid_pass_with_misses_before_and_after():
    rng = np.random.default_rng(1)
    case = _state(rng, srcs=range(12))
    # 100..103 take rows 12..15; 104.. find none; 101 again finds its row
    src = [100, 0, 101, 5, 100, 102, 103, 104, 105, 101, 106, 104, 3, 100,
           107, 108, 109, 104, 110]
    case.update(_items(src, rng=rng))
    got = check_pass(case)
    assert got["n_rows"] == N and got["dropped_rows"] >= 4, got


def test_probe_exhausted_src_then_rows_run_out():
    rng = np.random.default_rng(2)
    home = 7
    crowd = _keys_at_home(home, P)               # fill the window of home 7
    s = _keys_at_home(home, 1, start=crowd[-1] + 1)[0]
    case = _state(rng, srcs=crowd)
    # s first finds its window full (dropped_probes), then every row taken
    # (dropped_rows): the same src counts one and then the other
    src = [s] + list(range(200, 230)) + [s, s]
    case.update(_items(src, rng=rng))
    got = check_pass(case)
    assert got["dropped_probes"] >= 1 and got["dropped_rows"] >= 2
    assert got["n_rows"] == N


@pytest.mark.parametrize("tomb_first", [False, True])
def test_stored_empty_value_reads_as_a_miss(tomb_first):
    rng = np.random.default_rng(3)
    case = _state(rng, srcs=range(5))
    s = 500
    slot = (_home(s) + 1) & (H - 1) if tomb_first else _home(s)
    assert case["tab_keys"][slot] == -1
    if tomb_first:
        case["tab_keys"][_home(s)] = -2          # a TOMB before the key
    case["tab_keys"][slot], case["tab_vals"][slot] = s, -1
    case.update(_items([s, 1, s, s, 2, s], dst=[3, 3, 3, 5, 4, 3], rng=rng))
    got = check_pass(case)
    assert got["n_rows"] == 6


def test_tombstone_saturated_table():
    rng = np.random.default_rng(4)
    case = _state(rng, n_rows=3)
    case["tab_keys"][:] = -2                     # every slot a TOMB ...
    for row, key in enumerate((40, 41)):         # ... but two live keys
        case["tab_keys"][_home(key)], case["tab_vals"][_home(key)] = key, row
    case.update(_items([40, 600, 41, 601, 600, 602, 40, 601], rng=rng))
    got = check_pass(case)
    assert got["n_rows"] == 6


def test_duplicate_items_and_one_row_with_more_items_than_slots():
    rng = np.random.default_rng(5)
    case = _state(rng, srcs=range(8))
    case["cnt"][0] = [5, 1, 7, 2]                # row 0 full: evictions
    case["dst_slab"][0] = [20, 21, 22, 23]
    case["tot"][0] = 15
    src = [0] * 14 + [3, 3, 9, 9, 0, 3]
    dst = list(range(30, 44)) + [6, 6, 2, 2, 30, 6]
    case.update(_items(src, dst=dst, rng=rng))
    got = check_pass(case)
    assert got["evictions"] >= 2 * C


def test_no_active_item():
    rng = np.random.default_rng(6)
    case = _state(rng, srcs=range(10))
    case.update(_items([1, 50, 2, 51], active=[False] * 4, rng=rng))
    assert check_pass(case)["n_rows"] == 10


def test_no_item():
    rng = np.random.default_rng(7)
    case = _state(rng, srcs=range(10))
    case.update(_items([], rng=rng, length=0))
    assert check_pass(case)["n_rows"] == 10


def test_more_items_than_one_block_sorts():
    rng = np.random.default_rng(8)
    length = SORT_TILE + 500
    case = _state(rng, srcs=range(9))
    src = rng.integers(0, 30, length)
    active = rng.random(length) < 0.04
    case.update(_items(src, active=active, rng=rng, length=length))
    got = check_pass(case)
    assert got["n_rows"] == N and got["evictions"] > 0


# ---------------------------------------------------------------------------
# random small tables and batches
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_rows=st.integers(0, N),
       pool=st.integers(1, 48), p_active=st.floats(0.0, 1.0),
       tomb=st.floats(0.0, 0.9), stored_empty=st.floats(0.0, 0.3))
def test_random_passes(seed, n_rows, pool, p_active, tomb, stored_empty):
    rng = np.random.default_rng(seed)
    case = _state(rng, srcs=rng.permutation(60)[:n_rows], n_rows=n_rows)
    keys, vals = case["tab_keys"], case["tab_vals"]
    live = keys >= 0
    keys[live & (rng.random(H) < tomb)] = -2
    vals[live & (rng.random(H) < stored_empty)] = -1
    case["counters"][1:] = rng.integers(0, 5, 3)
    case.update(_items(rng.integers(0, pool, L), rng.integers(0, 6, L),
                       active=rng.random(L) < p_active, rng=rng))
    check_pass(case)


# ---------------------------------------------------------------------------
# the contract of the two forms: functional, and in place for the owner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", [
    (ref.slow_path_ref, ref.slow_path_ref_),
    (ref.slow_path_rows_ref, ref.slow_path_rows_ref_),
    (lambda *a: ops.slow_path(*a[:-1], max_probes=a[-1]),
     lambda *a, dirty: ops.slow_path_(*a[:-1], max_probes=a[-1], dirty=dirty))],
    ids=["slow_path_ref", "slow_path_rows_ref", "<lambda>"])
@pytest.mark.parametrize("own_counts", [False, True])
def test_own_counts_writes_cnt_and_tot_in_place_and_nothing_else(fn, own_counts):
    """The functional form writes none of its inputs; the in-place form
    (the owner owns every tensor the pass writes) writes the src table,
    dst_slab, cnt, tot and the counters and nothing else, and flags exactly
    the rows whose dst_slab, cnt or tot it changed."""
    functional, in_place = fn
    rng = np.random.default_rng(9)
    case = _state(rng, srcs=range(6))
    case.update(_items([0, 7, 7, 1, 8], rng=rng))
    args = _torch_args(case)
    before = [a.clone() for a in args]
    written = ("tab_keys", "tab_vals", "dst_slab", "cnt", "tot", "counters")
    if own_counts:
        dirty = torch.zeros(N, dtype=torch.uint8)
        in_place(*args, P, dirty=dirty)
        out = tuple(args[NAMES.index(name)] for name in written)
        changed = ((args[2] != before[2]) | (args[3] != before[3])).any(dim=1) \
            | (args[4] != before[4])
        assert torch.equal(dirty.bool(), changed) and changed.any()
    else:
        out = functional(*args, P)
        assert not any(out[i] is args[NAMES.index(name)]
                       for i, name in enumerate(written))
    assert_same(_jax(case), out, "pass")
    for name, a, b in zip(NAMES, args, before):
        assert torch.equal(a, b) != (own_counts and name in written), name


def _state_leaves(state):
    return (*state.src_table, *state.slabs, state.dh_keys, state.dh_vals,
            *(getattr(state, f) for f in tmc.SCALAR_FIELDS))


@pytest.mark.parametrize("update", [tmc.update_batch, tmc.update_batch_reference])
def test_update_batch_leaves_its_published_state_untouched(update, monkeypatch):
    """``update_batch`` hands the in-place pass the copies it made itself,
    never the state's tensors: a reader holding the state sees it
    unchanged."""
    cfg = tmc.MCConfig(num_rows=N, capacity=C, table_size=H, max_probes=P,
                       max_new_per_batch=8)
    rng = np.random.default_rng(10)
    state = tmc.init(cfg, device="cpu")
    for _ in range(3):
        state = update(state, rng.integers(0, 30, 40), rng.integers(0, 6, 40),
                       cfg=cfg)
    held = convert.state_to_numpy(state)
    given = []
    plain = ref.slow_path_ref_

    def spy(*args, **kw):
        given.append(args[:5] + args[6:7])
        return plain(*args, **kw)

    monkeypatch.setattr(ref, "slow_path_ref_", spy)
    new = update(state, rng.integers(0, 40, 40), rng.integers(0, 9, 40), cfg=cfg)
    (written,) = given
    held_storages = {x.untyped_storage().data_ptr()
                     for x in _state_leaves(state)}
    assert not any(x.untyped_storage().data_ptr() in held_storages
                   for x in written)
    assert tmc.counter_stats(new) != tmc.counter_stats(state)
    now = convert.state_to_numpy(state)
    for name, value in held.items():
        assert np.array_equal(now[name], value), name


@pytest.mark.parametrize("capacity", [1536, 1537])
def test_cuda_wrapper_takes_rows_its_shared_memory_cache_holds(capacity,
                                                               monkeypatch):
    """The row launch caches each row in 48 KiB of shared memory (4 warps x
    2 x C int32): the wrapper launches up to 1,536 slots and refuses more,
    before anything reaches the card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import slow_path as sp
    launched = []
    monkeypatch.setattr(_build, "require_cuda_int32", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "launch", lambda name, *a: launched.append(a))

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    args = (z(H), z(H), z(2, capacity), z(2, capacity), z(2), z(2, capacity),
            z(4), z(3), z(3), z(3), z(3))
    if capacity > 1536:
        with pytest.raises(ValueError, match="at most 1536 slots"):
            sp.slow_path_cuda_(*args, max_probes=P)
        assert not launched
    else:
        sp.slow_path_cuda_(*args, max_probes=P)
        assert len(launched) == 1 and capacity in launched[0]
