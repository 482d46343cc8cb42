"""Meta-event publishers (weed/notification/ sinks).

The port's copy of ``seaweedfs_tpu/notification/publisher.py``.
"""

from __future__ import annotations

import json
import threading

from ..util import http


class MemoryQueue:
    """Test/demo sink: collects messages in memory."""

    def __init__(self):
        self.messages: list[dict] = []

    def send(self, key: str, message: dict) -> None:
        self.messages.append({"key": key, **message})


class LogQueue:
    """Append NDJSON to a local log file (notification 'log' sink)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def send(self, key: str, message: dict) -> None:
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps({"key": key, **message}) + "\n")


class BrokerQueue:
    """Publish into the message broker (the kafka-sink analog)."""

    def __init__(self, broker_url: str, topic: str = "filer_events"):
        self.broker_url = broker_url
        self.topic = topic

    def send(self, key: str, message: dict) -> None:
        try:
            http.post_json(
                f"{self.broker_url}/publish",
                {
                    "topic": self.topic,
                    "key": key,
                    "value": json.dumps(message),
                },
            )
        except http.HttpError:
            pass  # notification is best-effort, like the reference


class NotificationPublisher:
    """Fan filer meta events out to configured queues; subscribe() it
    to a Filer (filer_notify.go NotifyUpdateEvent analog)."""

    def __init__(self, queues: list | None = None):
        self.queues = queues or []

    def __call__(self, event) -> None:
        message = {
            "ts_ns": event.ts_ns,
            "directory": event.directory,
            "event_type": "delete" if event.is_delete else "write",
            "old_entry": event.old_entry,
            "new_entry": event.new_entry,
        }
        key = (
            (event.new_entry or event.old_entry or {}).get(
                "full_path", event.directory
            )
        )
        for q in self.queues:
            q.send(key, message)
