"""The port's telemetry layer (``repro_torch.obs``) against the reference's
contracts: every test of ``tests/test_obs.py`` that builds no engine, run on
the port's modules — histogram accuracy, lock-free shard merging, spans and
the flight recorder, incident dumps, the exposition surface — plus the
catalog (the reference's, literally) and arming that stays per package.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs import export as jexport
from repro.obs import metrics as jobs
from repro_torch import obs as obs_pkg
from repro_torch.obs import metrics as obs
from repro_torch.obs import tracing
from repro_torch.obs.export import (MetricsDumper, MetricsServer, render_jsonl,
                                    render_prometheus)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    yield
    obs.disarm()
    jobs.disarm()
    tracing.enable_kernel_annotations(False)


# ---------------------------------------------------------------------------
# the catalog and the gate are the port's own
# ---------------------------------------------------------------------------


def test_catalog_and_histogram_layout_are_the_references():
    assert obs.METRIC_CATALOG == jobs.METRIC_CATALOG
    assert list(obs.METRIC_CATALOG) == list(jobs.METRIC_CATALOG)
    assert (obs.E_MIN, obs.E_MAX) == (jobs.E_MIN, jobs.E_MAX)
    for bpo in (1, 4, 16):
        np.testing.assert_array_equal(obs.bucket_edges(bpo),
                                      jobs.bucket_edges(bpo))
        for v in (0.0, 1e-9, 3e-4, 0.5, 7.0, 1e6):
            assert obs.bucket_index(v, bpo) == jobs.bucket_index(v, bpo)
    assert obs_pkg.METRIC_CATALOG is obs.METRIC_CATALOG


def test_arming_one_package_leaves_the_other_disarmed():
    obs.arm()
    assert obs.is_armed() and not jobs.is_armed()
    obs.disarm()
    jobs.arm()
    assert jobs.is_armed() and not obs.is_armed()
    reg = obs.Registry()
    reg.hist_record("engine.query", 1.0)
    assert reg.snapshot()["histograms"]["engine.query"]["count"] == 0


def test_arm_from_env_sets_the_gate_and_the_kernel_annotation_flag():
    assert obs.arm_from_env({}) is None and not obs.is_armed()
    got = obs.arm_from_env({"MCQ_METRICS": "1", "MCQ_TRACE_KERNELS": "yes",
                            "MCQ_METRICS_INCIDENT_DIR": "/x"})
    assert got == "/x" and obs.is_armed() and tracing.KERNEL_ANNOTATE
    assert not jobs.is_armed()


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_kernel_annotation_names_the_dispatch_in_a_profile(on):
    """With ``KERNEL_ANNOTATE`` on, a dispatcher of ``kernels/ops.py`` runs
    under ``record_function("mcq.<op>")`` and the profile shows the name;
    off, it does not.  The answer is the same either way."""
    import torch

    from repro_torch.kernels import ops
    cnt = torch.tensor([[1, 5, 3, 0], [2, 2, 7, 1]], dtype=torch.int32)
    order = torch.arange(4, dtype=torch.int32).repeat(2, 1)
    want = ops.oddeven_sort(cnt, order, passes=4)
    tracing.enable_kernel_annotations(on)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = ops.oddeven_sort(cnt, order, passes=4)
    assert torch.equal(got, want)
    names = {ev.key for ev in prof.key_averages()}
    assert ("mcq.oddeven_sort" in names) == on
    assert ops.oddeven_sort.__name__ == "oddeven_sort"


def test_snapshot_equals_the_references_for_the_same_records():
    """The same records through both registries give the same image."""
    images = []
    for mod in (obs, jobs):
        reg = mod.Registry(vectors={"bucket_traffic": 4})
        with mod.armed():
            reg.counter_add("updates", 3)
            reg.gauge_set("n_rows", 11)
            for v in (1e-4, 2e-3, 0.05, 0.05, 1.5):
                reg.hist_record("wal.append", v)
            reg.vector_add("bucket_traffic", np.array([1, 0, 5, 2]))
        images.append(reg.snapshot())
    assert images[0] == images[1]
    assert render_prometheus(images[0]) == jexport.render_prometheus(images[1])
    assert render_jsonl(images[0]) == jexport.render_jsonl(images[1])


# ---------------------------------------------------------------------------
# histogram accuracy (tests/test_obs.py:56-94)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bpo", [1, 4, 16])
def test_histogram_percentiles_track_numpy(bpo):
    reg = obs.Registry(buckets_per_octave=bpo)
    rng = np.random.default_rng(0)
    data = rng.lognormal(mean=-6.0, sigma=1.5, size=4000)
    with obs.armed():
        for v in data:
            reg.hist_record("engine.observe", float(v))
    h = reg.snapshot()["histograms"]["engine.observe"]
    assert h["count"] == data.size
    assert h["max"] == pytest.approx(float(data.max()))
    assert h["sum"] == pytest.approx(float(data.sum()), rel=1e-9)
    bound = (bpo + 1.0) / bpo
    for key, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
        true = float(np.quantile(data, q))
        assert 0.95 * true <= h[key] <= bound * true * 1.05, (
            f"bpo={bpo} {key}: est {h[key]} vs true {true}")


def test_histogram_extreme_values_clamp_to_edge_buckets():
    reg = obs.Registry()
    with obs.armed():
        reg.hist_record("engine.query", 0.0)
        reg.hist_record("engine.query", -1.0)
        reg.hist_record("engine.query", 1e-30)
        reg.hist_record("engine.query", 1e9)
    h = reg.snapshot()["histograms"]["engine.query"]
    assert h["count"] == 4
    assert h["max"] == pytest.approx(1e9)
    assert h["p99"] == pytest.approx(1024.0)


# ---------------------------------------------------------------------------
# lock-free shard merge (tests/test_obs.py:97-134)
# ---------------------------------------------------------------------------


def test_concurrent_counter_merge_is_exact():
    reg = obs.Registry()
    n_threads, m = 8, 5000
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(m):
            reg.counter_add("updates")
    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert reg.snapshot()["counters"]["updates"] == n_threads * m


def test_concurrent_histogram_merge_is_exact():
    reg = obs.Registry()
    n_threads, m = 6, 2000
    with obs.armed():
        def work(seed):
            rng = np.random.default_rng(seed)
            for v in rng.uniform(1e-4, 1e-1, m):
                reg.hist_record("engine.observe", float(v))
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    h = reg.snapshot()["histograms"]["engine.observe"]
    assert h["count"] == n_threads * m


# ---------------------------------------------------------------------------
# spans + flight recorder (tests/test_obs.py:137-191)
# ---------------------------------------------------------------------------


def test_span_nesting_records_parent():
    reg = obs.Registry()
    with obs.armed():
        with reg.span("engine.observe"):
            with reg.span("engine.apply"):
                pass
    by = {s["name"]: s for s in reg.spans()}
    assert by["engine.apply"]["parent"] == "engine.observe"
    assert by["engine.observe"]["parent"] is None
    snap = reg.snapshot()["histograms"]
    assert snap["engine.observe"]["count"] == 1
    assert snap["engine.apply"]["count"] == 1


def test_span_exception_safety():
    reg = obs.Registry()
    with obs.armed():
        with pytest.raises(RuntimeError, match="boom"):
            with reg.span("engine.query"):
                raise RuntimeError("boom")
        with reg.span("engine.topn"):
            pass
    by = {s["name"]: s for s in reg.spans()}
    assert by["engine.query"]["error"] is True
    assert by["engine.topn"]["error"] is False
    assert by["engine.topn"]["parent"] is None
    assert reg.snapshot()["histograms"]["engine.query"]["count"] == 1


def test_flight_recorder_ring_wraparound():
    reg = obs.Registry(flight_spans=4)
    with obs.armed():
        for i in range(10):
            with reg.span("engine.query", i=i):
                pass
    spans = reg.spans()
    assert len(spans) == 4
    assert [s["attrs"]["i"] for s in spans] == [6, 7, 8, 9]


def test_disarmed_span_and_hist_are_noops():
    reg = obs.Registry(vectors={"bucket_traffic": 4})
    assert reg.span("engine.query") is obs.NOOP_SPAN
    reg.hist_record("engine.query", 1.0)
    reg.vector_add("bucket_traffic", np.ones(4, np.int64))
    snap = reg.snapshot()
    assert snap["histograms"]["engine.query"]["count"] == 0
    assert sum(snap["vectors"]["bucket_traffic"]) == 0
    assert reg.spans() == []


# ---------------------------------------------------------------------------
# incident dumps (tests/test_obs.py:194-230)
# ---------------------------------------------------------------------------


def test_incident_dump_schema_deltas_and_cap(tmp_path):
    reg = obs.Registry(flight_spans=8, incident_dir=str(tmp_path),
                       max_incidents=2)
    with obs.armed():
        reg.counter_add("updates", 5)
        with reg.span("engine.observe"):
            pass
        path = reg.incident("strike_out", shard=1, error=ValueError("x"))
        assert path is not None and os.path.exists(path)
        with open(path) as f:
            doc = json.load(f)
        assert doc["schema"] == "mcq-incident-v1"
        assert doc["reason"] == "strike_out"
        assert doc["seq"] == 1
        assert doc["ctx"]["shard"] == 1
        assert "ValueError" in doc["ctx"]["error"]
        assert any(s["name"] == "engine.observe" for s in doc["spans"])
        assert doc["deltas"]["updates"] == 5
        reg.counter_add("updates", 3)
        path2 = reg.incident("strike_out")
        with open(path2) as f:
            assert json.load(f)["deltas"]["updates"] == 3
        assert reg.incident("strike_out") is None
        assert reg.snapshot()["counters"]["incidents"] == 3


def test_incident_without_dir_counts_but_writes_nothing():
    reg = obs.Registry()
    with obs.armed():
        assert reg.incident("poison") is None
    assert reg.snapshot()["counters"]["incidents"] == 1


def test_providers_merge_into_scalars():
    reg = obs.Registry()
    reg.counter_add("updates", 2)
    reg.gauge_set("n_rows", 9)
    reg.register_provider(lambda: {"updates": 7, "evictions": 1})
    assert reg.scalars() == {**{n: 0 for n in reg.snapshot()["counters"]},
                             "updates": 7, "n_rows": 9, "evictions": 1}


# ---------------------------------------------------------------------------
# exposition surface (tests/test_obs.py:233-290)
# ---------------------------------------------------------------------------


def _demo_registry():
    reg = obs.Registry(vectors={"bucket_traffic": 4, "shard_traffic": 2})
    with obs.armed():
        reg.counter_add("updates", 2)
        reg.gauge_set("store_version", 7)
        reg.hist_record("engine.observe", 0.01)
        reg.hist_record("engine.query", 0.001)
        reg.vector_add("bucket_traffic", np.array([1, 0, 2, 0]))
        reg.vector_add("shard_traffic", np.array([3, 0]))
    return reg


def test_prometheus_render_series():
    text = render_prometheus(_demo_registry().snapshot())
    assert "# TYPE mcq_updates counter" in text
    assert "mcq_updates 2" in text
    assert "mcq_store_version 7" in text
    assert "# TYPE mcq_engine_observe_seconds summary" in text
    assert 'mcq_engine_observe_seconds{quantile="0.5"}' in text
    assert "mcq_engine_observe_seconds_count 1" in text
    assert 'mcq_bucket_traffic{bucket="2"} 2' in text
    assert 'mcq_shard_traffic{shard="0"} 3' in text


def test_jsonl_render_parses_line_per_metric():
    lines = render_jsonl(_demo_registry().snapshot()).strip().splitlines()
    rows = [json.loads(line) for line in lines]
    by = {(r["type"], r["name"]): r for r in rows}
    assert by[("counter", "updates")]["value"] == 2
    assert by[("histogram", "engine.query")]["count"] == 1
    assert by[("vector", "bucket_traffic")]["nonzero"] == {"0": 1, "2": 2}


def test_metrics_http_endpoint_smoke():
    reg = _demo_registry()
    srv = MetricsServer(reg, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(url + "/metrics").read().decode()
        jbody = urllib.request.urlopen(url + "/metrics.json").read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/nope")
    finally:
        srv.close()
    assert 'mcq_engine_observe_seconds{quantile="0.5"}' in body
    assert 'mcq_engine_query_seconds{quantile="0.99"}' in body
    assert 'mcq_bucket_traffic{bucket="0"} 1' in body
    snap = json.loads(jbody)
    assert snap["counters"]["updates"] == 2


def test_metrics_dumper_writes_final_image(tmp_path):
    reg = _demo_registry()
    path = str(tmp_path / "metrics.jsonl")
    dumper = MetricsDumper(reg, path, every_s=30.0).start()
    dumper.close()
    rows = [json.loads(line) for line in open(path)]
    assert any(r["name"] == "engine.observe" for r in rows)


def test_persist_spans_record_into_the_ports_global_registry(tmp_path):
    """``save_snapshot`` / ``restore_snapshot`` and the WAL record their
    spans and histograms into the port's ``GLOBAL`` registry while armed,
    and nothing into the reference's."""
    from repro_torch.core import mcprioq as tmc
    from repro_torch.persist import snapshot as snapshot_io
    from repro_torch.persist.wal import WriteAheadLog
    cfg = tmc.MCConfig(num_rows=8, capacity=4)
    before = obs.GLOBAL.snapshot()["histograms"]
    jbefore = jobs.GLOBAL.snapshot()["histograms"]
    with obs.armed():
        snapshot_io.save_snapshot(tmc.init(cfg, device="cpu"),
                                  str(tmp_path / "s"), 0, {})
        snapshot_io.restore_snapshot(tmc.init(cfg, device="cpu"),
                                     str(tmp_path / "s"))
        with WriteAheadLog(str(tmp_path / "w"), fsync="always") as wal:
            wal.append([1], [2])
    after = obs.GLOBAL.snapshot()["histograms"]
    for name in ("snapshot.save", "snapshot.restore", "wal.append",
                 "wal.fsync", "wal.rotate"):
        assert after[name]["count"] == before[name]["count"] + 1, name
    assert jobs.GLOBAL.snapshot()["histograms"] == jbefore
