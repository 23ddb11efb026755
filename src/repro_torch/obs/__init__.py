"""Lock-free telemetry: metrics registry, spans/flight recorder, exposition.

See DESIGN.md §13.  Counterpart of ``repro.obs`` (host-only Python, its
own global registry and arming gate).  Quick tour::

    from repro_torch import obs

    obs.arm()                       # histograms/spans/vectors/incidents on
    reg = obs.Registry(vectors={"bucket_traffic": 256})
    with reg.span("engine.observe"):
        ...
    print(obs.render_prometheus(reg.snapshot()))
"""

from repro_torch.obs.metrics import (METRIC_CATALOG, GLOBAL, Registry, arm,
                                     arm_from_env, armed, disarm, is_armed)
from repro_torch.obs.export import (MetricsDumper, MetricsServer,
                                    render_jsonl, render_prometheus)
from repro_torch.obs import tracing

__all__ = [
    "METRIC_CATALOG", "GLOBAL", "Registry", "arm", "arm_from_env", "armed",
    "disarm", "is_armed", "MetricsDumper", "MetricsServer", "render_jsonl",
    "render_prometheus", "tracing",
]
