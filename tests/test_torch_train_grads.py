"""``Model.loss_fn``'s gradients in the port (``torch.autograd``,
``train.train_step.grads_of``) against ``jax.value_and_grad`` of the
reference's, one smoke config per family, on the CPU.

The same numpy parameters (the reference's ``init``) and batch go through
both at float32.  Bound, per leaf: max |port - reference| <= 2e-3 x the
leaf's largest |gradient| + 1e-6.  Measured: mamba2 1.3e-6 of the leaf's
largest, phi-3-vision 1.7e-5, qwen2 6.4e-5, deepseek-moe 3.2e-4,
recurrentgemma 4.2e-4, whisper 6.7e-4: random smoke models amplify float32
rounding (attention scores of +-100, random gates; whisper's float32
logits alone lie up to 2.5e-4 from a float64 run,
``tests/test_torch_models_encdec.py``).  The loss within 1e-5 relative.
One jitted reference trace per case.

And where the reference's gradient is NaN: ``mamba2-130m`` at full width
(one layer, 128 tokens: one SSD chunk of 128) overflows ``exp`` above the
intra-chunk diagonal, which the reference masks after the exponential, so
its backward is 0 * inf; the port masks the exponent.  The port's loss
equals the reference's within 1e-5 relative, every port gradient is
finite, and the leaves the reference gets finite agree within the bound
above.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import _paths_and_leaves as r_paths_and_leaves
from repro.configs import get_config as r_get_config
from repro.configs import smoke_config as r_smoke_config
from repro.models import Model as RModel
from repro_torch.checkpoint.ckpt import _paths_and_leaves
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import Model
from repro_torch.train.train_step import grads_of

FAMILIES = {"dense": "qwen2-7b", "moe": "deepseek-moe-16b",
            "ssm": "mamba2-130m", "hybrid": "recurrentgemma-9b",
            "encdec": "whisper-base", "vlm": "phi-3-vision-4.2b"}
REL, ABS = 2e-3, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def batch_for(cfg, rng, b=2, s=16):
    batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "targets")}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal((b, 24, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "patch":
        batch["prefix_embeds"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_gradients_match_jax_grad(family):
    arch = FAMILIES[family]
    r_cfg = dataclasses.replace(r_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    assert cfg.family == family
    r_model = RModel(r_cfg)
    r_params = r_model.init(jax.random.key(1))
    batch = batch_for(cfg, np.random.default_rng(1))
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(
        r_model.loss_fn, has_aux=True))(
            r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, r_params), device="cpu")
    grads, loss, _ = grads_of(Model(cfg), params, batch)
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    want_keys, want, _ = r_paths_and_leaves(r_grads)
    got_keys, got, _ = _paths_and_leaves(grads)
    assert got_keys == want_keys
    for key, w, g in zip(want_keys, want, got):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, key
        diff = float(np.abs(g.numpy() - w).max())
        assert diff <= REL * float(np.abs(w).max()) + ABS, (key, diff)


def test_ssd_gradients_stay_finite_where_the_references_overflow():
    r_cfg = dataclasses.replace(r_get_config("mamba2-130m"), num_layers=1,
                                dtype="float32")
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=1,
                              dtype="float32")
    r_model = RModel(r_cfg)
    r_params = r_model.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
             for k in ("tokens", "targets")}
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(
        r_model.loss_fn, has_aux=True))(
            r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    grads, loss, _ = grads_of(Model(cfg), model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, r_params), device="cpu"),
        batch)
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    keys, want, _ = r_paths_and_leaves(r_grads)
    got = _paths_and_leaves(grads)[1]
    nan_in_reference = []
    for key, w, g in zip(keys, want, got):
        w = np.asarray(w)
        assert bool(torch.isfinite(g).all()), key
        if not np.isfinite(w).all():
            nan_in_reference.append(key)
            continue
        diff = float(np.abs(g.numpy() - w).max())
        assert diff <= REL * float(np.abs(w).max()) + ABS, (key, diff)
    assert "stack/pos0/ssm/A_log" in nan_in_reference
