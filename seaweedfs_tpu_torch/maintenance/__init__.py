"""Autonomous maintenance plane: detect → schedule → execute.

The reference grew this subsystem twice — master-resident admin
scripts (weed/server/master_server.go:187-243 startAdminScripts) and
later the `weed worker` task plane — because a cluster serving real
traffic cannot wait for an operator to type `volume.vacuum` or notice
a dead shard. This package is the master-leader-resident equivalent:

* :mod:`policy`    — MaintenancePolicy knobs (+ SEAWEEDFS_MAINT_* env,
                     shared duration parsing for "1h"/"30m"/"90s")
* :mod:`tasks`     — typed task records and the task-type constants
* :mod:`detector`  — periodic topology/telemetry scan emitting task
                     candidates (vacuum, ec_encode, ec_rebuild,
                     fix_replication, balance)
* :mod:`ops`       — callable cluster-admin building blocks (the
                     shell commands' bodies, extracted so executors
                     call functions instead of shelling out)
* :mod:`scheduler` — priority queue + per-node/per-type caps,
                     cooldowns, dedupe, skip-if-degraded, worker pool,
                     history ring, metrics and trace spans
* :mod:`plane`     — MaintenancePlane tying it together on the master
                     (leader-only detector loop, cluster-lock sharing,
                     /cluster/maintenance view)

Control surfaces: `GET/POST /cluster/maintenance` on the master,
`weed shell` `maintenance.status|pause|resume|policy|run`, and
`SEAWEEDFS_MAINT_*` env. A held shell cluster lock pauses the
scheduler; every task run passes the `maintenance.task.run` fault
point and is recorded as a `maintenance.<type>` trace span.

The port's copy of ``seaweedfs_tpu/maintenance``: the same plane, whose
EC tasks reach the port's codec on the volume servers' device.
"""

from .plane import MaintenancePlane  # noqa: F401
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
