"""Servers of the port: the master (``master.MasterServer``, with its
raft in ``raft``), the volume server (``volume.VolumeServer``), the
filer (``filer.FilerServer``), the client side of the heartbeat stream
and the in-process ``harness.ClusterHarness``; the S3 gateway lives in
``seaweedfs_tpu_torch/s3``, and the WebDAV gateway is
``webdav.WebDavServer``."""
