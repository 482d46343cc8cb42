"""Host utilities of the port: the HTTP plumbing (``http``), retries and
circuit breakers (``retry``), config, leveled logging, limiters and
compression — the port's copies of ``seaweedfs_tpu/util`` that the
volume server stands on."""
