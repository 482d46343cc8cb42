"""Command-line subcommands.

The port's counterpart of ``seaweedfs_tpu/command``: the load generator
(``benchmark.py``). The ``weed`` CLI (``command/cli.py``) is not ported
yet, so this package exports no ``main``.
"""
