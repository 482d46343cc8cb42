"""Security: JWT-scoped write auth + access guard (weed/security/).

The port's copy of ``seaweedfs_tpu/security``: ``jwt`` and ``tls`` (the
dev PKI and the contexts the master and volume server take).
"""

from .jwt import Guard, decode_jwt, gen_jwt  # noqa: F401
