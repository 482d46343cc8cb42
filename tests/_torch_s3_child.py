"""One package's S3 gateway request sequence, alone in a fresh process.

``python tests/_torch_s3_child.py {ref|port} DIR`` starts a cluster of
that package with a filer and an S3 gateway (``with_s3``; the port's on
the CPU), sends the gateway nine requests and prints, as one JSON line,
the statuses, the gateway's request spans by op (component ``s3``) and
the ``SeaweedFS_s3_request_total`` lines of its ``/metrics``. In its own
interpreter no other gateway of the package adds to the counts.
"""

import http.client
import importlib
import json
import os
import sys

PACKAGES = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
SEQUENCE = (("PUT", "/b", b""), ("PUT", "/b/k1", b"one"),
            ("PUT", "/b/k2", b"two" * 100), ("PUT", "/b/k3", b"3"),
            ("GET", "/b/k1", b""), ("GET", "/b/k2", b""),
            ("HEAD", "/b/k1", b""), ("GET", "/b", b""),
            ("DELETE", "/b/k3", b""))


def call(host, method, path, body=b""):
    conn = http.client.HTTPConnection(host, timeout=60)
    try:
        conn.request(method, path, body=body or None)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def main(which, root):
    pkg = PACKAGES[which]
    if which == "port":
        import torch

        torch.set_num_threads(2)
    harness = importlib.import_module(f"{pkg}.server.harness")
    rec = importlib.import_module(f"{pkg}.tracing.recorder")
    kw = {"device": "cpu"} if which == "port" else {}
    with harness.ClusterHarness(n_volume_servers=1, volumes_per_server=8,
                                root=os.path.join(root, "c"), with_s3=True,
                                **kw) as c:
        c.wait_for_nodes(1)
        host = c.s3.url.split("//")[-1]
        statuses = [call(host, m, p, b)[0] for m, p, b in SEQUENCE]
        spans = {labels[1]: v[1] for labels, v in
                 rec.SPAN_SECONDS.snapshot().items() if labels[0] == "s3"}
        text = call(host, "GET", "/metrics")[1].decode()
    family = [ln for ln in text.splitlines()
              if "SeaweedFS_s3_request_total" in ln]
    print(json.dumps({"statuses": statuses, "spans": spans,
                      "family": family}))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
