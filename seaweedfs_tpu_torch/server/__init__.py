"""Servers of the port: the master (``master.MasterServer``, with its
raft in ``raft``), the volume server (``volume.VolumeServer``), the
filer (``filer.FilerServer``), the client side of the heartbeat stream
and the in-process ``harness.ClusterHarness``. The gateways (S3, WebDAV)
are not ported yet."""
