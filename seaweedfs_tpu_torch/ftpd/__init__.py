"""FTP gateway — stub, mirroring the reference's unfinished weed/ftpd
(ftp_server.go:1-81 defines only the option struct and a listener that
was never completed). Kept for component parity; the WebDAV and S3
gateways cover the file-transfer use cases.

The port's copy of ``seaweedfs_tpu/ftpd/__init__.py``.
"""

from dataclasses import dataclass


@dataclass
class FtpServerOptions:
    filer: str = "localhost:8888"
    ip: str = "localhost"
    port: int = 8021
    passive_port_start: int = 0
    passive_port_stop: int = 0


class FtpServer:
    def __init__(self, options: FtpServerOptions):
        self.options = options

    def start(self) -> None:
        raise NotImplementedError(
            "ftp gateway is a stub (as in the reference); use the "
            "webdav or s3 gateways"
        )
