"""`weed mount`: FUSE filesystem over the filer (weed/filesys analog).

The port's copy of ``seaweedfs_tpu/mount/__init__.py``.
"""

from .wfs import WFS, mount_filer  # noqa: F401
