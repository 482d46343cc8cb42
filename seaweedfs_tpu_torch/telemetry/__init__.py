"""Telemetry of the port: phase timing of the EC pipeline with its spans
and ``seaweedfs_phase_seconds`` histogram (``phases.py``), the
per-device dispatch ledger (``devices.py``), and the cluster telemetry
plane — per-server snapshots (``snapshot.py``), the master's aggregate
behind ``/cluster/telemetry`` (``aggregator.py``) and the slow-request
ledger (``slow.py``) — and the flight recorder (``recorder.py``) with
the ``/debug/*`` plane (``debug.py``, ``profile.py``).

This package init stays import-light (the stdlib-only ``slow``): the
heavier modules (``snapshot`` pulls in the stats, tracing and retry
stack) are imported where used.
"""

from .slow import LEDGER, SlowLedger  # noqa: F401
