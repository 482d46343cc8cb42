"""Cross-cluster replication: meta-event driven sinks + filer.sync.

The port's copy of ``seaweedfs_tpu/replication/__init__.py``.
"""

from .replicator import Replicator  # noqa: F401
from .sink import FilerSink, LocalSink  # noqa: F401
from .sync import FilerSync  # noqa: F401
