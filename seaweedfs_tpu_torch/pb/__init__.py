"""Wire contracts: dataclass messages serialized as JSON over HTTP.

The reference defines 3 gRPC services over protobuf (weed/pb/master.proto,
volume_server.proto, filer.proto). This build's control plane is asyncio
HTTP + JSON: same message shapes, Python-idiomatic transport. The compute
plane needs no RPC at all — it runs in process, on the card.
"""

from .messages import (  # noqa: F401
    EcShardInformationMessage,
    Heartbeat,
    VolumeInformationMessage,
    VolumeLocation,
)
