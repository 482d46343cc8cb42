"""Cluster maintenance: the admin flows the shell's commands call.

The port's copy of ``seaweedfs_tpu/maintenance`` without its autonomous
plane: :mod:`ops` (the callable bodies of ``ec.encode``, ``ec.rebuild``,
``volume.vacuum``, ``volume.fix.replication`` and ``volume.balance``),
:mod:`policy` (``MaintenancePolicy`` and the shared duration parsing)
and :mod:`tasks` (the task records and type constants). The detector,
scheduler and ``MaintenancePlane`` are not ported yet: a master given a
``maintenance_policy`` raises ``NotImplementedError``.
"""

from .policy import MaintenancePolicy, parse_duration  # noqa: F401
from .tasks import (  # noqa: F401
    BALANCE,
    EC_ENCODE,
    EC_REBUILD,
    FIX_REPLICATION,
    TASK_TYPES,
    VACUUM,
    MaintenanceTask,
)
