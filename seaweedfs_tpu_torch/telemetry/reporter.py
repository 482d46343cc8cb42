"""Periodic snapshot push for servers that don't heartbeat.

Volume servers piggyback their telemetry on the existing heartbeat;
the filer and S3 gateway have no heartbeat, so each runs one of these:
a daemon thread that assembles a `TelemetryCollector` snapshot every
`interval` seconds and POSTs it to the master's `/cluster/telemetry`
intake. Push failures are dropped on the floor — telemetry must never
back-pressure the data plane — and the next tick retries naturally.

The port's copy of ``seaweedfs_tpu/telemetry/reporter.py``.
"""

from __future__ import annotations

import threading
import time

from ..util import http
from ..util import retry as retry_mod
from .snapshot import TelemetryCollector


class TelemetryReporter:
    def __init__(
        self,
        component: str,
        url: str,
        master_url: str,
        interval: float = 10.0,
        extra: dict | None = None,
        *,
        tally,
    ):
        # `tally`: the server's own RequestTally (its TracedRouter's)
        self.collector = TelemetryCollector(component, url, tally=tally)
        self.master_url = master_url
        self.interval = interval
        # static fields merged into every pushed snapshot — e.g. a
        # sharded filer rides its shard identity here so the master
        # can publish the shard map beside /cluster/status
        self.extra = dict(extra or {})
        self._running = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop,
            name=f"telemetry-{component}",
            daemon=True,
        )

    def start(self) -> None:
        self._running = True
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._stop.set()

    def push_once(self) -> None:
        """One collect+push (also the loop body); raises on failure so
        tests can drive it synchronously."""
        snap = self.collector.collect()
        if self.extra:
            snap.update(self.extra)
        http.post_json(
            f"{self.master_url}/cluster/telemetry",
            snap,
            timeout=10,
            retry=retry_mod.LOOKUP,
        )

    def _loop(self) -> None:
        while self._running:
            self._stop.wait(self.interval)
            if not self._running:
                return
            try:
                self.push_once()
            except http.HttpError:
                continue  # master away: next tick re-tries
