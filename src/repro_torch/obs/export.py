"""Metrics exposition: Prometheus text, JSONL, and an embedded server.

Counterpart of ``repro.obs.export`` (host-only Python, kept line for
line).

``render_prometheus`` turns a registry snapshot into the Prometheus text
format (metric names prefixed ``mcq_``, dots to underscores; histograms
rendered as summaries with p50/p90/p99 quantile series plus ``_count`` /
``_sum`` / ``_max``; traffic vectors as labelled series).  ``render_jsonl``
emits one JSON object per metric for log-shipper pipelines.

``MetricsServer`` is a stdlib ``ThreadingHTTPServer`` on a daemon thread —
``GET /metrics`` for Prometheus scrape, ``GET /metrics.json`` for the raw
snapshot; port 0 binds an ephemeral port (``.port`` tells you which).
``MetricsDumper`` writes a JSONL snapshot file on a fixed cadence
(tmp + ``os.replace``, so a reader never sees a torn file).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator

from repro_torch.obs.metrics import METRIC_CATALOG, Registry


def _prom_name(name: str) -> str:
    return "mcq_" + name.replace(".", "_").replace("-", "_")


def _fmt(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _scalar_lines(section: dict, default_kind: str) -> Iterator[str]:
    for name in sorted(section):
        kind, help_ = METRIC_CATALOG.get(name, (default_kind, ""))
        pn = _prom_name(name)
        if help_:
            yield f"# HELP {pn} {help_}"
        yield f"# TYPE {pn} {kind if kind in ('counter', 'gauge') else 'gauge'}"
        yield f"{pn} {_fmt(section[name])}"


def render_prometheus(snap: dict) -> str:
    """Prometheus text exposition of a ``Registry.snapshot()``."""
    lines = []
    lines.extend(_scalar_lines(snap.get("counters", {}), "counter"))
    lines.extend(_scalar_lines(snap.get("gauges", {}), "gauge"))
    # provided names already covered by counters/gauges sections get a
    # distinct series only if absent there; the catalog supplies the kind
    seen = set(snap.get("counters", {})) | set(snap.get("gauges", {}))
    provided = {k: v for k, v in snap.get("provided", {}).items()
                if k not in seen or v}
    lines.extend(_scalar_lines(provided, "gauge"))
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        pn = _prom_name(name) + "_seconds"
        _, help_ = METRIC_CATALOG.get(name, ("histogram", ""))
        if help_:
            lines.append(f"# HELP {pn} {help_}")
        lines.append(f"# TYPE {pn} summary")
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            lines.append(f'{pn}{{quantile="{q}"}} {_fmt(h[key])}')
        lines.append(f"{pn}_count {h['count']}")
        lines.append(f"{pn}_sum {_fmt(h['sum'])}")
        lines.append(f"{pn}_max {_fmt(h['max'])}")
    for name in sorted(snap.get("vectors", {})):
        vec = snap["vectors"][name]
        pn = _prom_name(name)
        _, help_ = METRIC_CATALOG.get(name, ("vector", ""))
        if help_:
            lines.append(f"# HELP {pn} {help_}")
        lines.append(f"# TYPE {pn} gauge")
        label = "shard" if name == "shard_traffic" else "bucket"
        for i, v in enumerate(vec):
            if v:
                lines.append(f'{pn}{{{label}="{i}"}} {v}')
    return "\n".join(lines) + "\n"


def render_jsonl(snap: dict) -> str:
    """One JSON object per metric (counters, gauges, provided, histogram
    summaries, nonzero vector cells)."""
    rows = []
    for section, kind in (("counters", "counter"), ("gauges", "gauge"),
                          ("provided", "provided")):
        for name in sorted(snap.get(section, {})):
            rows.append({"type": kind, "name": name,
                         "value": snap[section][name]})
    for name in sorted(snap.get("histograms", {})):
        rows.append({"type": "histogram", "name": name,
                     **snap["histograms"][name]})
    for name in sorted(snap.get("vectors", {})):
        vec = snap["vectors"][name]
        rows.append({"type": "vector", "name": name,
                     "nonzero": {str(i): v for i, v in enumerate(vec) if v}})
    return "\n".join(json.dumps(r) for r in rows) + "\n"


def _make_handler(registry: Registry):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):   # noqa: N802 (stdlib API name)
            try:
                if self.path.startswith("/metrics.json"):
                    body = json.dumps(registry.snapshot(), indent=2)
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = render_prometheus(registry.snapshot())
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404)
                    return
            except Exception as e:   # surface scrape bugs, don't kill serve
                self.send_error(500, str(e))
                return
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            pass   # scrapes must not spam serve's stdout

    return Handler


class MetricsServer:
    """Serve ``registry`` over HTTP on a daemon thread."""

    def __init__(self, registry: Registry, port: int = 0,
                 host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_handler(registry))
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mcq-metrics-server")

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


class MetricsDumper:
    """Write a JSONL snapshot of ``registry`` to ``path`` every
    ``every_s`` seconds (atomic replace per cadence tick)."""

    def __init__(self, registry: Registry, path: str, every_s: float = 5.0):
        self._registry = registry
        self._path = path
        self._every_s = float(every_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="mcq-metrics-dumper")

    def _write_once(self) -> None:
        text = render_jsonl(self._registry.snapshot())
        directory = os.path.dirname(self._path) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, self._path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _run(self) -> None:
        while not self._stop.wait(self._every_s):
            self._write_once()

    def start(self) -> "MetricsDumper":
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write_once()   # final image on shutdown


__all__ = ["render_prometheus", "render_jsonl", "MetricsServer",
           "MetricsDumper"]
