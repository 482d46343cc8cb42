"""Telemetry of the port: phase timing of the EC pipeline."""
