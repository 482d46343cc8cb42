"""Admin shell: cluster maintenance commands over master/volume HTTP.

Behavioral model: weed/shell/ — command registry + exclusive cluster lock
+ the volume/EC maintenance workflows.

The port's copy of ``seaweedfs_tpu/shell`` with the EC commands
(``ec.encode``, ``ec.rebuild``, ``ec.decode``, ``ec.balance``) and the
cluster lock; the other command modules are not ported yet.
"""

from .commands import CommandEnv, all_commands, run_command  # noqa: F401
