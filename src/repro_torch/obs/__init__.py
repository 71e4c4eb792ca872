"""Observability for the port: metrics, traces and heartbeats.

Stdlib only, so every layer (engine, SAI, WAL, block store) can import it
without cycles.  The exporters, time series and HTTP endpoint of the JAX
package's ``obs`` come with the serving plane.
"""

from .metrics import Counter, CounterGroup, Gauge, Histogram, MetricsRegistry
from .trace import Span, Trace, Tracer
from .health import (
    Heartbeat,
    HeartbeatBoard,
    HealthConfig,
    HealthEngine,
    STATUS_CRITICAL,
    STATUS_OK,
    STATUS_WARN,
)

__all__ = [
    "Counter",
    "CounterGroup",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Trace",
    "Tracer",
    "Heartbeat",
    "HeartbeatBoard",
    "HealthConfig",
    "HealthEngine",
    "STATUS_CRITICAL",
    "STATUS_OK",
    "STATUS_WARN",
]
