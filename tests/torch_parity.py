"""Shared harness of the port's parity tests (a helper, not collected).

Runs a JAX callable of ``repro`` and a torch callable of ``repro_torch`` on
the same numpy inputs, flattens both results to named numpy leaves and
asserts equality leaf by leaf — tolerance zero, integers and float32 alike —
with the leaf's name in the failure message.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp


def leaves(x, prefix: str = "") -> dict:
    """Flatten a result (array, tensor, scalar, NamedTuple, tuple, list,
    dict) to ``{dotted name: numpy array}``; NamedTuple fields keep their
    names, so an ``MCState`` of either package gives the same 18 names."""
    if isinstance(x, torch.Tensor):
        return {prefix or "value": x.detach().cpu().numpy()}
    if isinstance(x, (jax.Array, np.ndarray, np.generic, int, float, bool)):
        return {prefix or "value": np.asarray(x)}
    if isinstance(x, dict):
        items = x.items()
    elif hasattr(x, "_fields"):
        items = zip(x._fields, x)
    elif isinstance(x, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(x))
    else:
        raise TypeError(f"cannot flatten {type(x)} at {prefix!r}")
    out = {}
    for name, value in items:
        out.update(leaves(value, f"{prefix}.{name}" if prefix else str(name)))
    return out


def assert_same(want, got, what: str = "") -> None:
    """``want`` (reference result) and ``got`` (port result) agree exactly,
    leaf by leaf: same names, shapes, kinds of dtype and values."""
    lw, lg = leaves(want), leaves(got)
    assert list(lw) == list(lg), f"{what}: leaf names {list(lw)} != {list(lg)}"
    for name in lw:
        a, b = lw[name], lg[name]
        assert a.shape == b.shape, f"{what}: leaf {name}: {a.shape} != {b.shape}"
        assert a.dtype.kind == b.dtype.kind or {a.dtype.kind, b.dtype.kind} <= set("iu"), (
            f"{what}: leaf {name}: dtype {a.dtype} vs {b.dtype}")
        if a.dtype.kind in "iu":  # the port carries uint32 values in int64
            a, b = a.astype(np.int64), b.astype(np.int64)
        if not np.array_equal(a, b):
            idx = np.argwhere(np.atleast_1d(a != b))[0]
            raise AssertionError(
                f"{what}: leaf {name} differs, first at index {tuple(idx)}: "
                f"reference {np.atleast_1d(a)[tuple(idx)]!r} vs port "
                f"{np.atleast_1d(b)[tuple(idx)]!r}")


def to_jax(x):
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, x)


def to_torch(x):
    return jax.tree_util.tree_map(
        lambda v: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v, x)


def check(jax_fn, torch_fn, *np_inputs, what: str = "", **static):
    """Call both functions on the same numpy inputs (converted to each
    framework's arrays; other arguments pass through) and compare."""
    want = jax_fn(*to_jax(list(np_inputs)), **static)
    got = torch_fn(*to_torch(list(np_inputs)), **static)
    assert_same(want, got, what or getattr(torch_fn, "__name__", "result"))
    return want, got


def jax_state_leaves(state) -> dict:
    """A JAX ``MCState`` as the dict of numpy leaves that
    ``repro_torch.convert.state_from_numpy`` takes."""
    return {k: np.asarray(v) for k, v in leaves(state).items()}


# ---------------------------------------------------------------------------
# the chain tests' shared configurations and stream
# ---------------------------------------------------------------------------

# every stream: 60 nodes of out-degree 12 (flat Zipf) into 48 rows of <= 8 slots, so rows
# run out (dropped_rows), slots run out (evictions) and the tight new-edge
# prefix overflows (deferred_new)
_BASE = dict(num_rows=48, capacity=8, max_probes=16, impl="ref")
CHAIN_CONFIGS = {
    "rolling": dict(_BASE, max_new_per_batch=12, sort_passes=1, decay_block_rows=20),
    "stop_the_world": dict(_BASE, max_new_per_batch=24, sort_passes=2),
    "unbounded_prefix_odd_capacity": dict(_BASE, capacity=5, sort_passes=1,
                                          decay_block_rows=48),
    "no_sort_small_table": dict(_BASE, max_new_per_batch=16, sort_passes=0,
                                table_size=64, max_probes=4, decay_block_rows=7),
}


def chain_configs(name):
    """``(reference MCConfig, port MCConfig)`` of one named configuration."""
    from repro.core import mcprioq as jmc
    from repro_torch.core import mcprioq as tmc
    kw = CHAIN_CONFIGS[name]
    return jmc.MCConfig(**kw), tmc.MCConfig(**kw)


def chain_stream(seed, n_batches=50, batch=64):
    """Batches with weights, masks, negative ids and injected new edges."""
    from repro_torch.data.synthetic import MarkovGraphSampler
    g = MarkovGraphSampler(num_nodes=60, out_degree=12, zipf_s=0.7, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    for i in range(n_batches):
        if i % 3 == 2:
            src, dst = g.sample_transitions_mixed(batch, 0.2, new_offset=i * batch)
        else:
            src, dst = g.sample_transitions(batch)
        src, dst = src.copy(), dst.copy()
        src[rng.random(batch) < 0.03] = -1           # negative ids are dropped
        dst[rng.random(batch) < 0.03] = -5
        weights = rng.integers(1, 4, batch).astype(np.int32) if i % 2 else None
        mask = (rng.random(batch) < 0.9) if i % 4 == 1 else None
        yield src, dst, weights, mask


def opt(x, conv):
    return None if x is None else conv(x)
