"""Metrics of the port: a Prometheus-text registry of its own
(``REGISTRY.expose()``)."""

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    REGISTRY,
)
