"""The port's SSM (``mamba2-130m``) and RG-LRU (``recurrentgemma-9b``)
families against the reference's, on the CPU.

The models run with the reference's own parameters (``model.init(key)`` as
numpy, carried over by ``convert.model_params_from_numpy``).  Tolerances:

  * the layers (``apply_ssm`` over several chunks, from a zero and from a
    warm cache, ``decode_ssm``, ``apply_rglru``, ``decode_rglru``) at
    float32: atol = rtol = 1e-5, and the associative scan's recursion equal
    to ``jax.lax.associative_scan``'s within 1e-6;
  * the archs at ``smoke_config`` with ``dtype="float32"``: ``prefill``
    logits within 1e-4; the port's ``extend_step`` (the decode step over
    each token in turn) within 1e-4 of the reference's sequential
    ``decode_step`` calls and within the reference's own 2e-3 of its
    ``extend_step`` (the associative / chunked form,
    ``tests/test_system.py::test_extend_step_matches_sequential_decode``);
    ``loss_fn``'s ce within 1e-4;
  * the bfloat16 default: as in ``tests/torch_lm_parity.py::
    check_bfloat16`` (the dense archs' bound of 1.0 / 0.15, and the port's
    bfloat16 at most 4x as far from float32 as the reference's bfloat16 is:
    ``recurrentgemma-9b``'s smoke logits move by up to 0.25 from the
    reference's rounding alone, the port's by up to 2.6x that, random
    gates amplifying an ulp).

And the port's own claim, bit for bit: an ``extend_step`` of K tokens ==
K ``decode_step`` calls, logits and every cache leaf, with pad rows (K <
``STEP_ROWS``) and without, the recurrent cache returned being the one
after the K real rows.  The reference's outputs are computed once per
module (``ref_outputs``), jitted.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import smoke_config as r_smoke_config
from repro.models import Model as RModel
from repro.models import rglru as r_rglru
from repro.models import ssm as r_ssm
from repro_torch.models import rglru
from repro_torch.models import ssm
from repro_torch.models.model import STEP_ROWS

from torch_lm_parity import (K, MAX_LEN, check_bfloat16,
                             check_extend_bit_for_bit, check_float32,
                             check_loss, check_tree, port_outputs,
                             reference_outputs)

ARCHS = ("mamba2-130m", "recurrentgemma-9b")
#: prompt lengths: two SSD chunks of 16; a prompt and an extension inside
#: the smoke config's attention window of 16, where the reference's cached
#: calls are exact (ROADMAP queue C 30)
SEQ = {"mamba2-130m": 32, "recurrentgemma-9b": 12}
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(want, got, tol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _block(cfg, kind, seed):
    """One block's reference parameters (float32) of a model of ``cfg``."""
    params = RModel(cfg).init(jax.random.key(seed))
    j = cfg.pattern.index(kind)
    p = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                               params["stack"][f"pos{j}"])
    return p[kind]


# ---------------------------------------------------------------------------
# the reference's outputs, once per module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_outputs():
    out = reference_outputs([(a, SEQ[a], ("float32", "bfloat16"))
                             for a in ARCHS])
    return {k[:2]: v for k, v in out.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("check", [check_float32, check_bfloat16, check_loss,
                                   check_tree])
def test_arch_against_the_reference(arch, check, ref_outputs):
    check(arch, ref_outputs[arch, "float32" if check is not check_bfloat16
                            else "bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_step_equals_sequential_decode_bit_for_bit(arch):
    check_extend_bit_for_bit(arch, 4)


# ---------------------------------------------------------------------------
# the SSD layer
# ---------------------------------------------------------------------------


def _ssm_inputs(seed, s):
    cfg = dataclasses.replace(r_smoke_config("mamba2-130m"), dtype="float32")
    p = _block(cfg, "ssm", seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    cache = r_ssm.SSMCache(
        state=rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_headdim,
                               cfg.ssm_state)).astype(np.float32),
        conv_buf=rng.normal(size=(2, cfg.ssm_conv - 1, r_ssm.conv_dim(cfg))
                            ).astype(np.float32))
    return cfg, p, x, cache


def _step_is_its_decodes(step, p, x, cache, cfg, real):
    """``step`` over ``real`` rows of ``x`` == ``real`` calls of one real
    row each at the same shape (the token at row 0), bit for bit: the
    output rows and the cache after the real rows; the pad rows' output is
    the out projection of zeros."""
    y, got = step(p, x, cache, cfg, real=real)
    c = cache
    for j in range(real):
        yj, c = step(p, torch.roll(x, -j, dims=1), c, cfg, real=1)
        assert torch.equal(yj[:, 0], y[:, j]), j
    for a, b in zip(got, c):
        assert torch.equal(a, b)
    assert bool((y[:, real:] == 0).all())


@pytest.mark.parametrize("warm", [False, True])
def test_apply_ssm_over_several_chunks_matches(warm):
    """48 rows in chunks of 16, from a zero cache or a random warm one:
    the output and the returned state and conv buffer."""
    cfg, p, x, cache = _ssm_inputs(11, 48)
    init = cache if warm else None
    r_out, r_cache = jax.jit(r_ssm.apply_ssm, static_argnums=(2, 3))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), cfg, True,
        initial=None if init is None else r_ssm.SSMCache(*map(jnp.asarray,
                                                              init)))
    out, got = ssm.apply_ssm(_t(p), torch.from_numpy(x), cfg,
                             return_state=True,
                             initial=None if init is None else
                             ssm.SSMCache(*_t(tuple(init))))
    _close(r_out, out, TOL, "apply_ssm")
    _close(r_cache.state, got.state, TOL, "state")
    _close(r_cache.conv_buf, got.conv_buf, TOL, "conv_buf")
    assert torch.equal(ssm.apply_ssm(
        _t(p), torch.from_numpy(x), cfg,
        initial=None if init is None else ssm.SSMCache(*_t(tuple(init)))),
        out)


def test_apply_ssm_refuses_a_length_the_chunks_do_not_split():
    cfg, p, x, _ = _ssm_inputs(12, 24)     # 24 rows, chunks of 16
    with pytest.raises(AssertionError):
        r_ssm.apply_ssm(jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x), cfg)
    with pytest.raises(ValueError, match="chunks of 16"):
        ssm.apply_ssm(_t(p), torch.from_numpy(x), cfg)


def test_decode_ssm_and_the_step_over_real_rows_match():
    """Three reference decode steps from a warm cache == the port's
    decode_ssm three times == step_ssm over 3 real rows of 8 (the cache
    after the real rows), the pad rows' output being the zero y's."""
    cfg, p, x, cache = _ssm_inputs(13, STEP_ROWS)
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    r_c = r_ssm.SSMCache(*map(jnp.asarray, cache))
    c = ssm.SSMCache(*_t(tuple(cache)))
    outs = []
    for j in range(3):
        r_y, r_c = r_ssm.decode_ssm(rp, jnp.asarray(x[:, j:j + 1]), r_c, cfg)
        y, c = ssm.decode_ssm(_t(p), torch.from_numpy(x[:, j:j + 1]), c, cfg)
        _close(r_y, y, TOL, f"decode_ssm {j}")
        outs.append(y)
    _close(r_c.state, c.state, TOL, "state")
    _close(r_c.conv_buf, c.conv_buf, TOL, "conv_buf")
    _close(torch.cat(outs, dim=1).numpy(),
           ssm.step_ssm(_t(p), torch.from_numpy(x), ssm.SSMCache(
               *_t(tuple(cache))), cfg, real=3)[0][:, :3], TOL, "step rows")
    _step_is_its_decodes(ssm.step_ssm, _t(p), torch.from_numpy(x),
                         ssm.SSMCache(*_t(tuple(cache))), cfg, 3)


# ---------------------------------------------------------------------------
# the RG-LRU layer
# ---------------------------------------------------------------------------


def _rglru_inputs(seed, s):
    cfg = dataclasses.replace(r_smoke_config("recurrentgemma-9b"),
                              dtype="float32")
    p = _block(cfg, "rglru", seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    cache = r_rglru.RGLRUCache(
        h=rng.normal(size=(2, cfg.rnn_width)).astype(np.float32),
        conv_buf=rng.normal(size=(2, cfg.ssm_conv - 1, cfg.rnn_width)
                            ).astype(np.float32))
    return cfg, p, x, cache


@pytest.mark.parametrize("n", [1, 2, 7, 16, 37])
def test_associative_scan_is_the_references_recursion(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    b = rng.normal(size=(2, n, 5)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e1[1] * e2[0] + e2[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)
    got = rglru.associative_scan(rglru._combine,
                                 [torch.from_numpy(a), torch.from_numpy(b)],
                                 dim=1)
    for w, g in zip(want, got):
        _close(w, g, 1e-6, f"scan of {n}")


@pytest.mark.parametrize("warm", [False, True])
def test_apply_rglru_matches(warm):
    cfg, p, x, cache = _rglru_inputs(21, 19)
    r_out, r_cache = jax.jit(r_rglru.apply_rglru, static_argnums=(2, 3))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), cfg, True,
        initial=r_rglru.RGLRUCache(*map(jnp.asarray, cache)) if warm
        else None)
    out, got = rglru.apply_rglru(
        _t(p), torch.from_numpy(x), cfg, return_state=True,
        initial=rglru.RGLRUCache(*_t(tuple(cache))) if warm else None)
    _close(r_out, out, TOL, "apply_rglru")
    _close(r_cache.h, got.h, TOL, "h")
    _close(r_cache.conv_buf, got.conv_buf, TOL, "conv_buf")


def test_decode_rglru_and_the_step_over_real_rows_match():
    cfg, p, x, cache = _rglru_inputs(22, STEP_ROWS)
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    r_c = r_rglru.RGLRUCache(*map(jnp.asarray, cache))
    c = rglru.RGLRUCache(*_t(tuple(cache)))
    outs = []
    for j in range(5):
        r_y, r_c = r_rglru.decode_rglru(rp, jnp.asarray(x[:, j:j + 1]), r_c,
                                        cfg)
        y, c = rglru.decode_rglru(_t(p), torch.from_numpy(x[:, j:j + 1]), c,
                                  cfg)
        _close(r_y, y, TOL, f"decode_rglru {j}")
        outs.append(y)
    _close(r_c.h, c.h, TOL, "h")
    _close(r_c.conv_buf, c.conv_buf, TOL, "conv_buf")
    _close(torch.cat(outs, dim=1).numpy(),
           rglru.step_rglru(_t(p), torch.from_numpy(x), rglru.RGLRUCache(
               *_t(tuple(cache))), cfg, real=5)[0][:, :5], TOL, "step rows")
    _step_is_its_decodes(rglru.step_rglru, _t(p), torch.from_numpy(x),
                         rglru.RGLRUCache(*_t(tuple(cache))), cfg, 5)


def _ring_by_position(k, v, positions):
    """A KV cache's entries sorted by position per sequence (empty slots
    dropped): [(positions, k, v)] per batch row."""
    out = []
    for b in range(positions.shape[0]):
        keep = np.flatnonzero(positions[b] >= 0)
        order = keep[np.argsort(positions[b][keep], kind="stable")]
        out.append((positions[b][order], k[b][order], v[b][order]))
    return out


def _near(want, got, what):
    """Within 1e-4 of the leaf's largest magnitude (K/V of the deeper
    layers reach +-12)."""
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def _same_cache(want, got, what):
    """A reference cache leaf tuple against the port's: recurrent caches
    leaf for leaf, KV caches by position (the port's ring is larger)."""
    if hasattr(got, "positions"):
        w = _ring_by_position(*(np.asarray(a, np.float32) for a in want[:2]),
                              np.asarray(want[2]))
        g = _ring_by_position(*(a.float().numpy() for a in got[:2]),
                              got.positions.numpy())
        for (wp, wk, wv), (gp, gk, gv) in zip(w, g):
            assert set(wp.tolist()) <= set(gp.tolist()), what
            sel = np.isin(gp, wp)
            assert np.array_equal(gp[sel], wp), what
            _near(wk, gk[sel], what)
            _near(wv, gv[sel], what)
        return
    for w, g in zip(want, got):
        _near(np.asarray(w, np.float32), g.float().numpy(), what)


def test_the_recurrent_caches_match_after_the_prefill_and_the_decodes(
        ref_outputs):
    """Every cache leaf of ``recurrentgemma-9b`` (rglru, and the ring
    attention by position) and ``mamba2-130m`` after the prefill and K
    decodes: the reference's stacked caches against the port's per-period
    lists, float32, within 1e-4 of each leaf's largest magnitude."""
    for arch in ARCHS:
        ref = ref_outputs[arch, "float32"]
        r_c = ref["caches"]
        port, p_params, _, _ = port_outputs(arch, "float32", ref)
        _, c = port.prefill(p_params, {"tokens": ref["prompt"]}, MAX_LEN)
        for j in range(K):
            _, c = port.decode_step(p_params, c,
                                    torch.from_numpy(ref["feed"][:, j:j + 1]),
                                    torch.from_numpy(ref["pos"] + j))
        for i, period in enumerate(c["stack"]):
            for name, leaf in period.items():
                want = jax.tree_util.tree_map(lambda a: a[i],
                                              r_c["stack"][name])
                _same_cache(want, leaf, f"{arch} stack {i} {name}")
        for i, (want, got) in enumerate(zip(r_c.get("tail", []),
                                            c.get("tail", []))):
            _same_cache(want, got, f"{arch} tail {i}")
