"""Admin shell: cluster maintenance commands over master/volume HTTP.

Behavioral model: weed/shell/ — command registry + exclusive cluster lock
+ the volume/EC maintenance workflows.

The port's copy of ``seaweedfs_tpu/shell``: every command of the
reference (``ec.*``, ``volume.*``, ``collection.*``, ``cluster.*``,
``maintenance.*``, ``trace.*``, ``fault.*``) and the cluster lock, but
the filer's ``fs.*`` and the gateway's ``s3.*``, which wait for those
tiers.
"""

from .commands import CommandEnv, all_commands, run_command  # noqa: F401
