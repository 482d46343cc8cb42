"""Message broker: topic pub/sub persisted through the filer.

The port's copy of ``seaweedfs_tpu/messaging/__init__.py``.
"""

from .broker import MessageBroker, OffsetRecoveryError  # noqa: F401
