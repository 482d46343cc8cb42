"""Command-line subcommands.

The port's counterpart of ``seaweedfs_tpu/command``: the ``weed`` CLI
(``cli.py``, run as ``python -m seaweedfs_tpu_torch``) and the load
generator (``benchmark.py``).
"""

from .cli import main  # noqa: F401
