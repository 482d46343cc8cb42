"""Sharded filer metadata plane: hash-partitioned namespace routing.

The filer tier scales horizontally the same way the blob tier does:
N independent ``FilerServer`` shards, each owning its own store file,
with a deterministic client-side ``ShardMap`` (stable hash of the
top-level bucket/directory prefix) deciding which shard owns a path.
``FilerRing`` is the client router every filer consumer threads
through — the S3 gateway, the FUSE mount, the benchmark personas,
filer replication, and the scale harness (`spec suffix fN`,
``weed filer -shard i/N``).

The master publishes the shard map beside ``/cluster/status``
(``FilerShards``) so clients re-resolve after shard restarts exactly
like ``MasterRing`` re-resolves leaders.

The port's copy of ``seaweedfs_tpu/filer/sharding/__init__.py``.
"""

from .ring import (  # noqa: F401
    RENAME_DIR,
    FilerRing,
    ShardMap,
    primary_url,
    ring_of,
)
