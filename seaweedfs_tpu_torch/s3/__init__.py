"""S3-compatible gateway over the filer (weed/s3api analog).

The port's copy of ``seaweedfs_tpu/s3/__init__.py``.
"""

from .s3api import S3ApiServer  # noqa: F401
