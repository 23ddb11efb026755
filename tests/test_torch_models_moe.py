"""The port's mixture-of-experts family (``deepseek-moe-16b``,
``moonshot-v1-16b-a3b``) against the reference's, on the CPU.

The models run with the reference's own parameters (``model.init(key)`` as
numpy, carried over by ``convert.model_params_from_numpy``).  Tolerances:

  * ``apply_moe`` at float32, both combines: the output within atol = rtol
    = 1e-5 and ``moe_lb_loss`` / ``moe_z_loss`` within 1e-5, and the
    integers ``moe_dropped`` and ``moe_expert_counts`` EQUAL — also where
    the capacity drops tokens, and where pad rows sit beside the tokens
    (the capacity is the tokens', the pad rows are not dispatched);
  * the archs at ``smoke_config`` with ``dtype="float32"``: ``prefill``
    logits and the port's ``extend_step`` within 1e-4 of the reference's
    prefill and sequential ``decode_step`` calls, and within the
    reference's own 2e-3 of its ``extend_step``; ``loss_fn``'s ce, loss,
    ``moe_lb_loss`` and ``moe_z_loss`` within 1e-4;
  * the bfloat16 default: as in ``tests/torch_lm_parity.py::
    check_bfloat16`` — here bfloat16 rounding alone moves the reference's
    logits by up to 2.3 (a near tie of the router picks another expert),
    so the absolute bound is twice that where it exceeds 1.0.

And the port's own claim, bit for bit: an ``extend_step`` of K tokens ==
K ``decode_step`` calls, logits and every cache leaf, with pad rows and
without.  Shared helpers: ``tests/torch_lm_parity.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import smoke_config as r_smoke_config
from repro.models import Model as RModel
from repro.models import moe as r_moe
from repro_torch.models import moe
from repro_torch.models.mlp import apply_mlp

from torch_lm_parity import (check_bfloat16, check_extend_bit_for_bit,
                             check_float32, check_loss, check_tree, close,
                             reference_outputs)

ARCHS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")
S = 12
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref_outputs():
    out = reference_outputs([(a, S, ("float32", "bfloat16")) for a in ARCHS],
                            seed0=100)
    return {k[:2]: v for k, v in out.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("check", [check_float32, check_bfloat16, check_loss,
                                   check_tree])
def test_arch_against_the_reference(arch, check, ref_outputs):
    check(arch, ref_outputs[arch, "float32" if check is not check_bfloat16
                            else "bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_step_equals_sequential_decode_bit_for_bit(arch):
    check_extend_bit_for_bit(arch, 5)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _moe_inputs(seed, tokens, **changes):
    cfg = dataclasses.replace(r_smoke_config("deepseek-moe-16b"),
                              dtype="float32", **changes)
    params = RModel(cfg).init(jax.random.key(seed))
    p = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                               params["stack"]["pos0"]["moe"])
    x = np.random.default_rng(seed).normal(
        size=(2, tokens // 2, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def _reference_moe(cfg, p, x):
    out, aux = jax.jit(r_moe.apply_moe, static_argnums=2)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), cfg)
    return np.asarray(out), {k: np.asarray(v) for k, v in aux.items()}


def _same_aux(want, got, what):
    assert sorted(want) == sorted(got), what
    for k in ("moe_dropped", "moe_expert_counts"):
        assert got[k].dtype == torch.int32, (what, k)
        assert np.array_equal(want[k], got[k].numpy()), (what, k)
    for k in ("moe_lb_loss", "moe_z_loss"):
        close(want[k], got[k], TOL, f"{what} {k}")


def _torch(p):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p)


@pytest.mark.parametrize("combine", ["scatter", "gather"])
@pytest.mark.parametrize("tokens,factor", [(24, 1.25), (1024, 0.5)])
def test_apply_moe_matches(combine, tokens, factor):
    """24 tokens (no drop) and 1,024 tokens at a capacity factor of 0.5
    (cap 128 for 256 pairs an expert on average: the capacity drops
    pairs), both combines."""
    cfg, p, x = _moe_inputs(31, tokens, moe_combine=combine,
                            capacity_factor=factor)
    want, w_aux = _reference_moe(cfg, p, x)
    got, aux = moe.apply_moe(_torch(p), torch.from_numpy(x), cfg)
    close(want, got, TOL, f"apply_moe {combine}")
    _same_aux(w_aux, aux, f"{combine} {tokens}")
    assert (int(aux["moe_dropped"]) > 0) == (tokens == 1024)


def test_pad_rows_take_no_capacity_and_are_not_dispatched():
    """512 tokens beside 512 pad rows (two sequences of 256 tokens in 512
    rows): the capacity is the tokens' (128, where all 1,024 rows would
    give 256), so the tokens drop exactly as the reference's
    ``apply_moe`` over the tokens alone drops them; their outputs and aux
    equal its; a pad row's output is the shared experts' alone."""
    cfg, p, x = _moe_inputs(32, 1024, capacity_factor=1.0)
    assert moe._capacity(512, cfg) == 128 < moe._capacity(1024, cfg)
    real = x.shape[1] // 2
    want, w_aux = _reference_moe(cfg, p, x[:, :real])
    assert int(w_aux["moe_dropped"]) > 0
    got, aux = moe.apply_moe(_torch(p), torch.from_numpy(x), cfg, real=real)
    close(want, got[:, :real], TOL, "tokens beside pad rows")
    _same_aux(w_aux, aux, "pad rows")
    shared = apply_mlp(_torch(p)["shared"], torch.from_numpy(x[:, real:]),
                       cfg)
    close(shared.numpy(), got[:, real:], TOL, "pad rows")


def test_router_ties_go_to_the_lower_expert():
    """Equal router probabilities: ``top_k`` takes the lower expert ids, as
    ``lax.top_k`` does."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe.top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.array_equal(np.asarray(want_i), idx.numpy())
    assert np.array_equal(np.asarray(want_v), vals.numpy())
