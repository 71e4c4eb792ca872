"""Observability for the port: metrics, traces, exporters, health.

``obs`` is dependency-free (stdlib only) so every layer — engine, SAI,
WAL, block store, node runtime, gateway, transport — can import it
without cycles.  Metric names, the ``repro`` Prometheus namespace and
the health verdict rules are those of docs/OBSERVABILITY.md, so
dashboards carry over unchanged between the JAX package and the port.
"""

from .metrics import Counter, CounterGroup, Gauge, Histogram, MetricsRegistry
from .trace import Span, Trace, Tracer
from .export import dump_slow_log, flatten, prometheus_text, truncate_tree
from .health import (
    Heartbeat,
    HeartbeatBoard,
    HealthConfig,
    HealthEngine,
    STATUS_CRITICAL,
    STATUS_OK,
    STATUS_WARN,
)
from .timeseries import MetricsSampler
from .httpexport import HealthHTTPServer

__all__ = [
    "Counter",
    "CounterGroup",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Trace",
    "Tracer",
    "dump_slow_log",
    "flatten",
    "prometheus_text",
    "truncate_tree",
    "Heartbeat",
    "HeartbeatBoard",
    "HealthConfig",
    "HealthEngine",
    "HealthHTTPServer",
    "MetricsSampler",
    "STATUS_CRITICAL",
    "STATUS_OK",
    "STATUS_WARN",
]
