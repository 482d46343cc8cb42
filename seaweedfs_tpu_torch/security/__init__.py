"""Security: JWT-scoped write auth + access guard (weed/security/).

The port's copy of ``seaweedfs_tpu/security`` without ``tls.py``, which
comes with the port of the master.
"""

from .jwt import Guard, decode_jwt, gen_jwt  # noqa: F401
