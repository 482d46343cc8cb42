"""Filer: metadata tier mapping paths → chunked files over volumes.

Behavioral model: weed/filer/ — Entry model, pluggable FilerStore SPI,
chunked files with visible-interval resolution, metadata event log.

The port's copy of ``seaweedfs_tpu/filer/__init__.py``.
"""

from .entry import Attr, Entry, FileChunk  # noqa: F401
from .filechunks import (  # noqa: F401
    VisibleInterval,
    non_overlapping_visible_intervals,
    total_size,
)
from .filer import Filer  # noqa: F401
from .filerstore import FilerStore  # noqa: F401
from .stores import (  # noqa: F401
    LogStructuredStore,
    MemoryStore,
    SqliteStore,
)
