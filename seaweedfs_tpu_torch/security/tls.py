"""Transport security: TLS / mutual TLS between components.

Behavioral model: weed/security/tls.go — every component (master,
volume, filer, client) can load a cert/key pair plus a CA from
security.toml; servers then require client certificates signed by the
CA (mTLS), and clients verify servers against the same CA.

Python's ssl module carries the transport; `util.http` consumes these
contexts for both the ThreadingHTTPServer listeners and the outbound
client connections, so the whole control+data plane speaks HTTPS when
configured.

The port's copy of ``seaweedfs_tpu/security/tls.py``.
"""

from __future__ import annotations

import os
import ssl
import subprocess


def server_context(
    cert_file: str,
    key_file: str,
    ca_file: str | None = None,
) -> ssl.SSLContext:
    """Server-side context; with `ca_file` set, client certificates
    are REQUIRED and verified (mTLS — tls.go LoadServerTLS)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    if ca_file:
        ctx.load_verify_locations(ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(
    ca_file: str,
    cert_file: str | None = None,
    key_file: str | None = None,
) -> ssl.SSLContext:
    """Client-side context: verify servers against the CA; present a
    client certificate when given (tls.go LoadClientTLS)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(ca_file)
    # cluster certs are issued to component names, not hostnames; the
    # CA signature is the trust anchor (the reference likewise dials
    # by address with a shared cluster CA)
    ctx.check_hostname = False
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file or cert_file)
    return ctx


def generate_test_pki(directory: str | os.PathLike) -> dict[str, str]:
    """Dev/test PKI via the openssl CLI: one CA, one server pair, one
    client pair (the `weed scaffold security` starting point).

    Returns {"ca", "server_cert", "server_key", "client_cert",
    "client_key"} paths.
    """
    d = os.fspath(directory)
    os.makedirs(d, exist_ok=True)
    paths = {
        "ca": f"{d}/ca.crt",
        "ca_key": f"{d}/ca.key",
        "server_cert": f"{d}/server.crt",
        "server_key": f"{d}/server.key",
        "client_cert": f"{d}/client.crt",
        "client_key": f"{d}/client.key",
    }

    def run(*args):
        subprocess.run(
            ["openssl", *args],
            check=True,
            capture_output=True,
        )

    run(
        "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", paths["ca_key"], "-out", paths["ca"],
        "-days", "7", "-subj", "/CN=seaweedfs-tpu-test-ca",
    )
    for role in ("server", "client"):
        key = paths[f"{role}_key"]
        crt = paths[f"{role}_cert"]
        csr = f"{d}/{role}.csr"
        run(
            "req", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key, "-out", csr,
            "-subj", f"/CN=seaweedfs-tpu-{role}",
        )
        subprocess.run(
            [
                "openssl", "x509", "-req", "-in", csr,
                "-CA", paths["ca"], "-CAkey", paths["ca_key"],
                "-CAcreateserial", "-out", crt, "-days", "7",
                "-extfile", "/dev/stdin",
            ],
            input=b"subjectAltName=IP:127.0.0.1,DNS:localhost",
            check=True,
            capture_output=True,
        )
        os.remove(csr)
    return paths
