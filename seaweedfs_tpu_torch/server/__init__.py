"""Servers of the port: the volume server (``volume.VolumeServer``) and
the client side of its heartbeat stream. The master, filer and gateways
are not ported yet."""
