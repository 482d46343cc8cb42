"""Server-side JSON query over needle contents (weed/query analog).

The port's copy of ``seaweedfs_tpu/query/``.
"""

from .json_query import (  # noqa: F401
    apply_filter,
    get_path,
    project,
    query_json_lines,
)
