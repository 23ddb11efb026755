"""The back-buffer learner's catch-up by row flags and table flags, on the CPU.

The new-edge pass is the one writer of the src table: it flags the group of
every slot it writes (``hashtable.flag_group``), and the catch-up copies the
flagged rows, the flagged table groups and the scalars, and nothing whole.
After every catch-up the back equals the published front in all 18 leaves
and both kinds of flag are clear, through the owner calls of a chain (new
srcs, a decay), of the drafter and of a stacked state of 3 shards; the
learner's published chain equals the JAX reference's functional chain.  The
bound catch-up (checked once, launched per write) equals the functional
one, and the odd-even kernel's row geometry is what its source computes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro_torch.core import hashtable as tht
from repro_torch.core import mcprioq as tmc
from repro_torch.core import sharded as tsh
from repro_torch.core import speculative as tspec
from repro_torch.core.epoch import BackBufferLearner, EpochStore
from repro_torch.data.synthetic import token_stream
from repro_torch.kernels import oddeven, ops, ref

from torch_parity import assert_same, chain_stream, leaves, opt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(state):
    return getattr(state, "chain", state)


def _checked(learner, op):
    """``op`` as a learner write that first holds the back the catch-up
    left to the published front: every leaf equal, both flags clear."""
    def write(back, *args, dirty, table_dirty, **kw):
        snap = learner.store.acquire()
        learner.store.release(snap)
        front, caught = leaves(_chain(snap.state)), leaves(_chain(back))
        assert list(front) == list(caught) and len(front) == 18
        for name in front:
            assert np.array_equal(front[name], caught[name]), name
        assert not dirty.any() and not table_dirty.any()
        return op(back, *args, dirty=dirty, table_dirty=table_dirty, **kw)
    return write


KW = dict(num_rows=48, capacity=8, max_probes=16, max_new_per_batch=12,
          sort_passes=1, decay_block_rows=20, impl="ref")


def test_chain_learner_catches_up_by_flags_and_publishes_the_jax_chain():
    """``update_batch_`` with new srcs (rows and table slots taken), every
    third write ``decay_`` after it: each catch-up leaves the back equal to
    the front; each published state equals the reference's functional
    ``update_batch`` / ``decay`` stream."""
    jcfg, tcfg = jmc.MCConfig(**KW), tmc.MCConfig(**KW)
    jstate = jmc.init(jcfg)
    learner = BackBufferLearner(EpochStore(tmc.init(tcfg, device="cpu")))

    def update(back, src, dst, weights, mask, decay, *, dirty, table_dirty):
        tmc.update_batch_(back, src, dst, weights, mask, cfg=tcfg,
                          dirty=dirty, table_dirty=table_dirty)
        return tmc.decay_(back, cfg=tcfg, dirty=dirty) if decay else back

    for i, (src, dst, weights, mask) in enumerate(
            chain_stream(seed=5, n_batches=12)):
        jstate = jmc.update_batch(
            jstate, jnp.asarray(src), jnp.asarray(dst),
            opt(weights, jnp.asarray), opt(mask, jnp.asarray), cfg=jcfg)
        if i % 3 == 2:
            jstate = jmc.decay(jstate, cfg=jcfg)
        published = learner.write(_checked(learner, update), src, dst,
                                  weights, mask, i % 3 == 2)
        assert_same(jstate, published, f"learner write {i}")
    stats = tmc.counter_stats(published)
    assert stats["n_rows"] > 20 and stats["decay_steps"] > 0, stats


def test_drafter_learner_catches_up_by_flags():
    ncfg = tspec.NGramConfig(order=2, decay_threshold=12, mc=tmc.MCConfig(
        num_rows=32, capacity=4, sort_passes=1, decay_block_rows=7,
        max_new_per_batch=16, max_probes=16))
    learner = BackBufferLearner(EpochStore(tspec.init(ncfg, device="cpu")))
    functional = tspec.init(ncfg, device="cpu")

    def learn(back, tokens, *, dirty, table_dirty):
        tspec.observe_(back, tokens, cfg=ncfg, dirty=dirty,
                       table_dirty=table_dirty)
        return tspec.maintain_(back, cfg=ncfg, dirty=dirty)

    stream = token_stream(6, 4, 12, seed=8)
    for i in range(10):
        tokens = next(stream)["tokens"]
        functional = tspec.maintain(tspec.observe(functional, tokens,
                                                  cfg=ncfg), cfg=ncfg)
        published = learner.write(_checked(learner, learn), tokens)
        assert_same(functional.chain, published.chain, f"write {i}")
    assert tmc.counter_stats(functional.chain)["evictions"] > 0


def test_stacked_learner_catches_up_every_shard_in_one_call():
    """A stacked state of 3 shards: ``[S, N]`` row flags, ``[S, G]`` table
    flags, one catch-up; the published states equal the functional
    sharded calls'."""
    scfg = tsh.ShardedConfig(base=tmc.MCConfig(**KW), num_shards=3)
    learner = BackBufferLearner(EpochStore(tsh.init_sharded(scfg,
                                                            device="cpu")))
    assert learner._table_dirty.shape == (3, tht.flag_count(
        scfg.base.resolved_table_size()))
    functional = tsh.init_sharded(scfg, device="cpu")
    update = tsh.make_update_fn(scfg)
    maintain = tsh.make_maintain_fn(scfg, total_threshold=6)

    def step(back, src, dst, w, *, dirty, table_dirty):
        tsh.update_(back, src, dst, w, scfg=scfg, dirty=dirty,
                    table_dirty=table_dirty)
        return tsh.maintain_(back, scfg=scfg, total_threshold=6, dirty=dirty)

    for i, (src, dst, _, _) in enumerate(chain_stream(seed=9, n_batches=10,
                                                      batch=60)):
        src, dst = torch.from_numpy(src), torch.from_numpy(dst)
        w = torch.ones_like(src)
        functional = maintain(update(functional, src, dst, w))
        published = learner.write(_checked(learner, step), src, dst, w)
        assert_same(functional, published, f"stacked write {i}")
    assert int(published.n_rows.sum()) > 30


def _groups_changed(before, after, size):
    keys0, vals0 = before
    keys1, vals1 = after
    changed = (keys0 != keys1) | (vals0 != vals1)
    return changed.view(-1, tht.flag_group(size)).any(dim=1)


@pytest.mark.parametrize("table_size", [64, 16, 0], ids=lambda t: f"T{t}")
@pytest.mark.parametrize("write", ["update_batch_", "slow_path_ref_",
                                   "slow_path_rows_ref_"])
def test_table_flags_mark_exactly_the_slot_groups_the_new_edge_pass_wrote(
        write, table_size):
    """Every write's table flags against its before and after: a group is
    flagged exactly where a key or a value of it changed (a group of 32
    slots, or the whole table of 16)."""
    cfg = tmc.MCConfig(**dict(KW, table_size=table_size))
    size = cfg.resolved_table_size()
    state = tmc.init(cfg, device="cpu")
    counters = tmc.scalars_of(state, 4)
    for i, (src, dst, weights, mask) in enumerate(
            chain_stream(seed=3, n_batches=8)):
        table_dirty = torch.zeros(tht.flag_count(size), dtype=torch.uint8)
        before = [x.clone() for x in state.src_table]
        if write == "update_batch_":
            tmc.update_batch_(state, src, dst, weights, mask, cfg=cfg,
                              table_dirty=table_dirty)
        else:
            src_t, dst_t, w_t, m_t = tmc._batch_inputs(state, src, dst,
                                                       weights, mask)
            getattr(ref, write)(*state.src_table, state.slabs.dst,
                                state.slabs.cnt, state.slabs.tot,
                                state.slabs.order, counters, src_t, dst_t,
                                w_t, m_t, cfg.max_probes,
                                table_dirty=table_dirty)
        want = _groups_changed(before, state.src_table, size)
        assert torch.equal(table_dirty.bool(), want), (i, table_dirty, want)
    assert int(state.n_rows) >= min(20, size)   # rows and slots were taken


def test_without_table_flags_nothing_is_flagged_and_the_state_is_the_same():
    cfg = tmc.MCConfig(**KW)
    a, b = tmc.init(cfg, device="cpu"), tmc.init(cfg, device="cpu")
    table_dirty = torch.zeros(tht.flag_count(cfg.resolved_table_size()),
                              dtype=torch.uint8)
    for src, dst, weights, mask in chain_stream(seed=4, n_batches=4):
        tmc.update_batch_(a, src, dst, weights, mask, cfg=cfg)
        tmc.update_batch_(b, src, dst, weights, mask, cfg=cfg,
                          table_dirty=table_dirty)
    assert_same(a, b, "with and without table flags")
    assert table_dirty.any()


def _catch_up_case(rng, n=40, c=5, t=128, k=30):
    def ints(*shape):
        return torch.from_numpy(rng.integers(-2, 90, shape).astype(np.int32))
    front = (ints(n, c), ints(n, c), ints(n, c), ints(n), ints(t), ints(t),
             ints(k), ints(n, 4), ints(n, 4))
    back = tuple(ints(*x.shape) for x in front)
    dirty = torch.from_numpy((rng.random(n) < 0.3).astype(np.uint8))
    table_dirty = torch.from_numpy((rng.random(t // 32) < 0.5).astype(np.uint8))
    return front, back, dirty, table_dirty


@pytest.mark.parametrize("row_hashes", [True, False])
def test_bound_catch_up_equals_the_functional_one_both_ways(row_hashes):
    """``ops.bind_copy_dirty_rows`` (both directions over one pair of
    states) then ``ops.copy_bound_rows`` per call == ``ops.copy_dirty_rows``
    on copies, the flags cleared alike."""
    rng = np.random.default_rng(11)
    front, back, dirty, table_dirty = _catch_up_case(rng)
    cut = 9 if row_hashes else 7
    front, back = front[:cut], back[:cut]
    bound = (ops.bind_copy_dirty_rows(front, back, dirty, table_dirty),
             ops.bind_copy_dirty_rows(back, front, dirty, table_dirty))
    for turn in (0, 1, 0):
        src, dst = (front, back) if turn == 0 else (back, front)
        want = [x.clone() for x in dst]
        flags = (dirty.clone(), table_dirty.clone())
        ops.copy_dirty_rows(src, want, *flags)
        ops.copy_bound_rows(bound[turn])
        assert all(torch.equal(x, y) for x, y in zip(dst, want))
        assert not dirty.any() and not table_dirty.any()
        # the next write's flags
        dirty.copy_(torch.from_numpy((rng.random(40) < 0.3).astype(np.uint8)))
        table_dirty.copy_(torch.tensor([1, 0, 0, 1], dtype=torch.uint8))
        for x in src:
            x.add_(1)


@pytest.mark.parametrize("capacity,lanes,rows", [
    (1, 1, 32), (2, 1, 32), (3, 2, 16), (15, 8, 4), (16, 8, 4), (17, 16, 2),
    (31, 16, 2), (32, 16, 2), (33, 32, 1), (64, 32, 1), (128, 32, 1),
    (7264, 32, 1)])
def test_oddeven_geometry_packs_rows_into_warps(capacity, lanes, rows):
    """A row takes next_pow2(ceil(C/2)) lanes, at most 32; a warp holds
    32 / lanes rows; a block's rows fit its shared memory, and the widest
    row the earlier kernel took (C = 7,264) still fits."""
    got_lanes, got_rows, warps = oddeven.geometry(capacity)
    assert (got_lanes, got_rows) == (lanes, rows)
    assert 1 <= warps <= 8
    assert warps * rows * 2 * capacity * 4 <= 232448
    assert oddeven.MAX_CAPACITY >= 7264


def test_oddeven_ablation_finds_its_anchors_and_runs_on_the_card_only():
    """``scripts/oddeven_ablation.py`` imports nothing of the reference,
    finds every anchor it edits in ``csrc/oddeven.cu`` (each variant differs
    from the kernel and from the others), times the yardstick kernels of
    ``scripts/baseline_kernels.cu``, and exits non-zero without a GPU."""
    import ast
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    path = root / "scripts" / "oddeven_ablation.py"
    imported = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert not imported & {"jax", "jaxlib", "repro", "tools"}
    spec = importlib.util.spec_from_file_location("oddeven_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    source = (root / "src" / "repro_torch" / "kernels" / "csrc"
              / "oddeven.cu").read_text()
    variants = mod.variants(source)
    assert variants["oddeven"] == source
    changed = [v for k, v in variants.items() if k != "oddeven"]
    assert changed and len(set(changed + [source])) == len(changed) + 1
    baseline = (root / "scripts" / "baseline_kernels.cu").read_text()
    for entry in ("mcq_base_oddeven", "mcq_base_copy_dirty_rows"):
        assert f'extern "C" int {entry}(' in baseline
    if not torch.cuda.is_available():
        assert mod.main([]) == 2
