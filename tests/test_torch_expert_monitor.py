"""The expert-popularity monitor (``repro_torch.core.expert_monitor``)
against the reference's, tolerance 0: both scenarios of
``tests/test_expert_monitor.py`` replayed on the same histograms, every
leaf of the state equal after every ``observe``, and ``balance_report`` /
``hot_experts`` equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import expert_monitor as jem
from repro.core import mcprioq as jmc
from repro_torch.core import expert_monitor as tem

from torch_parity import assert_same


def _observe_both(jstate, tstate, layer, counts, jcfg, tcfg, what):
    jstate = jem.observe(jstate, layer, jnp.asarray(counts), jcfg)
    tstate = tem.observe(tstate, layer, counts, tcfg)
    assert_same(jstate, tstate, what)
    return jstate, tstate


def _reports_equal(jstate, tstate, jcfg, tcfg, layers, ts):
    for t in ts:
        assert tem.balance_report(tstate, tcfg, t=t) == \
            jem.balance_report(jstate, jcfg, t=t)
        for layer in layers:
            want, got = jem.hot_experts(jstate, layer, t, jcfg), \
                tem.hot_experts(tstate, layer, t, tcfg)
            assert_same(want, got, f"hot_experts layer {layer} t {t}")


@pytest.fixture(autouse=True)
def _jit_the_reference_decay(monkeypatch):
    """The reference's ``maybe_decay`` is not jitted (~1 s per eager call)."""
    monkeypatch.setattr(jmc, "maybe_decay", jax.jit(
        jmc.maybe_decay, static_argnames=("cfg", "total_threshold")))


def test_monitor_flags_imbalance_as_the_reference():
    kw = dict(num_layers=4, num_experts=16)
    jcfg, tcfg = jem.MonitorConfig(**kw), tem.MonitorConfig(**kw)
    assert tcfg.mc_config().capacity == jcfg.mc_config().capacity == 16
    jstate, tstate = jem.init(jcfg), tem.init(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    for step in range(20):
        c0 = np.roll(rng.multinomial(512, [0.85] + [0.01] * 15), 3)
        c1 = rng.multinomial(512, [1 / 16] * 16)
        for layer, counts in ((0, c0), (1, c1)):
            jstate, tstate = _observe_both(jstate, tstate, layer, counts, jcfg,
                                           tcfg, f"step {step} layer {layer}")
    _reports_equal(jstate, tstate, jcfg, tcfg, range(4), (0.5, 0.8, 0.9))
    report = tem.balance_report(tstate, tcfg, t=0.8)
    assert report[0] <= 2 and report[1] >= 12, report
    ids, load, _ = tem.hot_experts(tstate, 0, 0.5, tcfg)
    assert int(ids[0]) == 3 and float(load[0]) > 0.7


def test_monitor_decay_tracks_drift_as_the_reference():
    kw = dict(num_layers=1, num_experts=8, decay_threshold=4096)
    jcfg, tcfg = jem.MonitorConfig(**kw), tem.MonitorConfig(**kw)
    jstate, tstate = jem.init(jcfg), tem.init(tcfg, device="cpu")
    hot_a = np.array([900, 10, 10, 10, 10, 10, 10, 10], np.int32)
    hot_b = np.array([10, 10, 10, 10, 10, 10, 10, 900], np.int32)
    for i, counts in enumerate([hot_a] * 8 + [hot_b] * 16):
        jstate, tstate = _observe_both(jstate, tstate, 0, counts, jcfg, tcfg,
                                       f"observe {i}")
    assert int(tstate.decay_steps) > 0
    _reports_equal(jstate, tstate, jcfg, tcfg, [0], (0.5, 0.9))
    assert int(tem.hot_experts(tstate, 0, 0.5, tcfg)[0][0]) == 7


def test_monitor_takes_zero_counts_and_tensors():
    """Experts with no traffic are masked out of the update, as the
    reference's ``mask=counts > 0``; a tensor histogram is taken too."""
    kw = dict(num_layers=2, num_experts=5, sort_passes=1)
    jcfg, tcfg = jem.MonitorConfig(**kw), tem.MonitorConfig(**kw)
    jstate, tstate = jem.init(jcfg), tem.init(tcfg, device="cpu")
    for i, counts in enumerate(([0, 3, 0, 7, 1], [2, 0, 0, 0, 0], [0] * 5)):
        counts = np.array(counts, np.int32)
        jstate = jem.observe(jstate, i % 2, jnp.asarray(counts), jcfg)
        tstate = tem.observe(tstate, i % 2, torch.from_numpy(counts), tcfg)
        assert_same(jstate, tstate, f"observe {i}")
    _reports_equal(jstate, tstate, jcfg, tcfg, range(2), (1.0,))
    assert tem.balance_report(tstate, tcfg, t=1.0) == {0: 3, 1: 1}
