"""The port's encoder-decoder (``whisper-base``) and patch-prefix
(``phi-3-vision-4.2b``) families against the reference's, on the CPU.

The models run with the reference's own parameters (``model.init(key)`` as
numpy, carried over by ``convert.model_params_from_numpy``, ``enc_stack``
and ``enc_norm`` included); a batch carries stub frames [2, 24, D] or
patch embeddings [2, 4, D] beside its tokens, and a ``vlm``'s decodes
continue at ``4 + s``.  Tolerances, as ``tests/torch_lm_parity.py`` states
them for every family:

  * at ``smoke_config`` with ``dtype="float32"``: ``prefill`` logits
    within 1e-4; the port's ``extend_step`` within 1e-4 of the reference's
    sequential ``decode_step`` calls (5e-4 for ``whisper-base``, below) and
    within 2e-3 of its ``extend_step``; ``loss_fn``'s metrics within 1e-4.
    ``whisper-base``'s smoke model amplifies float32 rounding: against the
    same decodes run by the port in float64, the reference's float32
    decodes lie up to 8.9e-5 off and the port's up to 2.5e-4 (seeds 3 and
    7), so the two float32 runs are held to 5e-4 of each other there;
  * the bfloat16 default: the largest |logit difference| at most
    max(1.0, 2x the reference's own bfloat16 rounding) and the mean at most
    max(0.15, 2x its mean), the port's bfloat16 at most 4x as far from
    float32 as the reference's is (``check_bfloat16``);
  * ``sinusoidal_positions``: the port's table (``torch`` on the CPU)
    within 1e-7 of a float64 sin / cos of the same float32 angles, and
    within 2.5e-4 of the reference's.  XLA's float32 ``sin``/``cos`` lose
    up to 1.2e-4 at whisper's angles (up to 1,499 rad: 1,500 frames); at
    angles below 64 rad the two tables agree within 1e-6.

And the port's own claims, bit for bit: an extension == its decodes
(logits and every cache leaf, ``mem_k``/``mem_v`` never written after the
prefill), and a prefill or extension whose tokens reach past whisper's
decoder self-cache is refused by name (ROADMAP queue C).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.models import common as r_common
from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.models import common

from torch_lm_parity import (K, MAX_LEN, check_bfloat16,
                             check_extend_bit_for_bit, check_float32,
                             check_loss, check_tree, extra_inputs,
                             reference_outputs)

ARCHS = ("whisper-base", "phi-3-vision-4.2b")
S = 12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref_outputs():
    out = reference_outputs([(a, S, ("float32", "bfloat16")) for a in ARCHS],
                            seed0=7)
    return {(a, d): v for (a, d, _), v in out.items()}


@pytest.mark.parametrize("check", [check_float32, check_bfloat16, check_loss,
                                   check_tree])
@pytest.mark.parametrize("arch", ARCHS)
def test_matches_the_reference(arch, check, ref_outputs):
    ref = ref_outputs[arch, "float32" if check is not check_bfloat16
                      else "bfloat16"]
    if check is check_float32 and arch == "whisper-base":
        check(arch, ref, seq_tol=5e-4)
    else:
        check(arch, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_extension_equals_its_decodes_bit_for_bit(arch):
    check_extend_bit_for_bit(arch, 6)


def test_extensions_leave_the_projected_memory_as_the_prefill_wrote_it():
    cfg = smoke_config("whisper-base")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(1)
    _, caches = model.prefill(params, {
        "tokens": rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32),
        **extra_inputs(cfg, rng)}, MAX_LEN)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, K)).astype(
        np.int32))
    _, ext = model.extend_step(params, caches, feed,
                               torch.full((2,), 5, dtype=torch.int32))
    for c, e in zip(caches["stack"], ext["stack"]):
        for key in ("mem_k", "mem_v"):
            assert c["pos0"][key].shape[1] == 24
            assert torch.equal(c["pos0"][key], e["pos0"][key])
            assert float(c["pos0"][key].abs().sum()) > 0
        # only the K tokens entered the self-cache
        got = e["pos0"]["self"].positions
        assert (got >= 0).sum(dim=1).tolist() == [5 + K, 5 + K]


def test_sinusoidal_positions_against_the_reference_and_float64():
    for length, d, vs_ref in ((1500, 512, 2.5e-4), (64, 128, 1e-6)):
        got = common.sinusoidal_positions(length, d)
        assert got.dtype == torch.float32 and got.shape == (length, d)
        want = np.asarray(r_common.sinusoidal_positions(length, d))
        assert np.abs(got.numpy() - want).max() <= vs_ref, (length, d)
        pos = torch.arange(length, dtype=torch.float32)[:, None]
        inv = torch.exp(-math.log(10_000.0) * torch.arange(
            d // 2, dtype=torch.float32)[None, :] / (d // 2 - 1))
        ang = (pos * inv).double()
        exact = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        assert (got.double() - exact).abs().max() <= 1e-7, (length, d)
    assert torch.equal(common.sinusoidal_positions(9, 16, "cpu"),
                       common.sinusoidal_positions(9, 16))


def test_tokens_past_the_decoder_self_cache_are_refused():
    """whisper's decoder positions are a learned table of
    ``decoder_max_len`` (64 at smoke size); the self-cache holds
    min(decoder_max_len, max_len) positions.  The reference's scatter drops
    a write past it silently; the port refuses the call by name.  Pad rows
    past the end are not tokens."""
    cfg = dataclasses.replace(smoke_config("whisper-base"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(2)
    frames = extra_inputs(cfg, rng)

    def prompt(n):
        return {"tokens": rng.integers(0, cfg.vocab_size, (2, n)).astype(
            np.int32), **frames}

    with pytest.raises(ValueError, match="does not fit the decoder's "
                                         "self-cache of 16 positions"):
        model.prefill(params, prompt(17), 16)
    with pytest.raises(ValueError, match="self-cache of 64 positions"):
        model.prefill(params, prompt(65), 100)
    _, caches = model.prefill(params, prompt(12), 16)
    feed = torch.zeros((2, 3), dtype=torch.int32)
    # positions 12..14 fit (their pad rows 15..19 do not, and need not)
    model.extend_step(params, caches, feed, torch.full((2,), 12))
    model.decode_step(params, caches, feed[:, :1], torch.full((2,), 15))
    with pytest.raises(ValueError, match="position 16 does not fit"):
        model.decode_step(params, caches, feed[:, :1], torch.tensor([3, 16]))
    with pytest.raises(ValueError, match="position 16 does not fit"):
        model.extend_step(params, caches, feed, torch.full((2,), 14))


def test_the_families_build_at_full_width():
    """Both archs' full trees as meta tensors, the encoder's leaves
    stacked over its 6 layers."""
    from repro_torch.configs import get_config
    whisper = Model(get_config("whisper-base")).abstract_params()
    assert whisper["enc_stack"]["pos0"]["attn"]["wq"].shape == (6, 512, 8, 64)
    assert set(whisper["stack"]["pos0"]) >= {"xattn", "norm_x"}
    phi = Model(get_config("phi-3-vision-4.2b")).abstract_params()
    assert "enc_stack" not in phi and phi["stack"]["pos0"]["mlp"]["w1"].shape \
        == (32, 3072, 8192)
