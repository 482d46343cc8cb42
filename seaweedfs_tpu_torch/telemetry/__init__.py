"""Telemetry of the port: phase timing of the EC pipeline with its spans
and ``seaweedfs_phase_seconds`` histogram (``phases.py``), and the
per-device dispatch ledger (``devices.py``)."""
