"""Servers of the port: the master (``master.MasterServer``, with its
raft in ``raft``), the volume server (``volume.VolumeServer``), the
client side of the heartbeat stream and the in-process
``harness.ClusterHarness``. The filer and gateways are not ported yet."""
