"""Typed maintenance tasks: the unit the detector emits and the
scheduler runs.

Leaf module (stdlib only) so policy/detector/scheduler/shell can all
import the type constants without cycles.

The port's copy of ``seaweedfs_tpu/maintenance/tasks.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

VACUUM = "vacuum"
EC_ENCODE = "ec_encode"
EC_REBUILD = "ec_rebuild"
FIX_REPLICATION = "fix_replication"
BALANCE = "balance"

TASK_TYPES = (VACUUM, EC_ENCODE, EC_REBUILD, FIX_REPLICATION, BALANCE)

# smaller = more urgent: durability repairs outrank space reclamation,
# which outranks the warm-storage encode, which outranks cosmetics
PRIORITY = {
    EC_REBUILD: 0,
    FIX_REPLICATION: 1,
    VACUUM: 2,
    EC_ENCODE: 3,
    BALANCE: 4,
}

QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
FAILED = "failed"
SKIPPED = "skipped"

_seq_lock = threading.Lock()
_seq = 0  # guarded-by: _seq_lock


def next_task_id() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


@dataclass
class MaintenanceTask:
    """One unit of cluster maintenance work."""

    type: str
    volume_id: int = 0
    collection: str = ""
    # server urls the task touches (feeds the per-node concurrency cap
    # and the skip-if-degraded telemetry check)
    nodes: list[str] = field(default_factory=list)
    reason: str = ""
    batch: str = ""
    detail: dict = field(default_factory=dict)
    id: int = field(default_factory=next_task_id)
    priority: int = -1
    state: str = QUEUED
    created: float = field(default_factory=time.time)
    started: float = 0.0
    finished: float = 0.0
    error: str = ""

    def __post_init__(self):
        if self.priority < 0:
            self.priority = PRIORITY.get(self.type, 9)

    def key(self) -> tuple[str, int]:
        """Dedupe/cooldown identity: one live task per (type, volume)."""
        return (self.type, self.volume_id)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "type": self.type,
            "volume_id": self.volume_id,
            "collection": self.collection,
            "nodes": list(self.nodes),
            "reason": self.reason,
            "batch": self.batch,
            "detail": dict(self.detail),
            "priority": self.priority,
            "state": self.state,
            "created": self.created,
            "started": self.started,
            "finished": self.finished,
            "error": self.error,
        }
