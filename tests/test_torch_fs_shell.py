"""The port's ``fs.*`` shell commands (``shell/command_fs.py``) and chunk
manifests (``filer/filechunk_manifest.py``) held against the reference's
on the CPU.

Each package's shell drives each package's filer (over a cluster of the
same package, the port's on ``device="cpu"``) through one script of all
13 ``fs.*`` commands; the four outputs are equal, with wall-clock times
and chunk fids masked in ``fs.meta.cat`` and the ``fs.meta.save`` dump.
Manifests: the same chunk lists fold into the same manifests and resolve
back, and a file written past ``manifest_batch`` reads back through
either package's filer.
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu import operation as ref_operation  # noqa: E402
from seaweedfs_tpu.filer import entry as ref_entry  # noqa: E402
from seaweedfs_tpu.filer import filechunk_manifest as ref_mf  # noqa: E402
from seaweedfs_tpu.server.filer import (  # noqa: E402
    FilerServer as RefFilerServer,
)
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefClusterHarness,
)
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv  # noqa: E402
from seaweedfs_tpu.shell import run_command as ref_run  # noqa: E402
from seaweedfs_tpu.util import retry as ref_retry  # noqa: E402
from seaweedfs_tpu_torch import operation as port_operation  # noqa: E402
from seaweedfs_tpu_torch.filer import entry as port_entry  # noqa: E402
from seaweedfs_tpu_torch.filer import (  # noqa: E402
    filechunk_manifest as port_mf,
)
from seaweedfs_tpu_torch.server.filer import FilerServer  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.shell import CommandEnv  # noqa: E402
from seaweedfs_tpu_torch.shell import run_command as port_run  # noqa: E402
from seaweedfs_tpu_torch.util import http as port_http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

SHELLS = {"ref": (RefCommandEnv, ref_run), "port": (CommandEnv, port_run)}
STACKS = {"ref": (RefClusterHarness, RefFilerServer, {}),
          "port": (ClusterHarness, FilerServer, {"device": "cpu"})}


def _reset_clients():
    for op, retry in ((port_operation, port_retry),
                      (ref_operation, ref_retry)):
        op.client._lookup_cache.clear()
        retry.BREAKERS.reset()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """One cluster and filer of each package, kept for the module."""
    out, open_ = {}, []
    try:
        for which, (harness, filer_cls, kw) in STACKS.items():
            c = harness(n_volume_servers=2, volumes_per_server=25,
                        root=str(tmp_path_factory.mktemp(which)), **kw)
            open_.append(c)
            c.wait_for_nodes(2)
            fs = filer_cls(c.master.url, chunk_size=1024, manifest_batch=5,
                           telemetry_interval=0)
            fs.start()
            open_.append(fs)
            out[which] = (c, fs)
        yield out
    finally:
        for obj in reversed(open_):
            obj.stop()
        _reset_clients()


def _mask_json(text):
    doc = json.loads(text)
    for k in ("Mtime",):
        if k in doc:
            doc[k] = "<t>"
    return doc


def _mask_dump(path):
    """The ``fs.meta.save`` dump with times and fids masked."""
    rows = []
    for line in open(path):
        text = re.sub(r'"(file_id|hard_link_id)": "[^"]*"',
                      r'"\1": "<id>"', line)
        text = re.sub(r'"(mtime|crtime)": [0-9.e+]+', r'"\1": "<t>"', text)
        rows.append(json.loads(text))
    return rows


def _script(shell, stack, tmp_path):
    env_cls, run = SHELLS[shell]
    c, fs = stack
    filer_cls = type(fs)
    env = env_cls(c.master.url)
    out = []

    def sh(line):
        try:
            out.append((line, run(env, line)))
        except Exception as e:
            out.append((line, type(e).__name__))

    sh("fs.ls /sh")  # before fs.configure: no filer
    sh(f"fs.configure -filer {fs.url}")
    out[-1] = (out[-1][0].split()[0], out[-1][1].replace(fs.url, "<f>"))
    port_http.request("POST", f"{fs.url}/sh/a.txt", b"AAAA")
    port_http.request("POST", f"{fs.url}/sh/sub/b.txt", b"BB" * 700)
    port_http.request("POST", f"{fs.url}/sh/sub/deep/c.bin",
                      bytes(range(256)) * 30)
    for line in ("fs.ls /sh", "fs.ls /sh/sub", "fs.cat /sh/a.txt",
                 "fs.du /sh", "fs.du /sh/sub", "fs.tree /sh",
                 "fs.mkdir /sh/made", "fs.ls /sh",
                 "fs.mv /sh/a.txt /sh/renamed.txt",
                 "fs.cat /sh/renamed.txt", "fs.cat /sh/a.txt",
                 "fs.cd sub", "fs.pwd", "fs.ls", "fs.cat b.txt",
                 "fs.cd ../sub/./deep", "fs.pwd", "fs.cd /", "fs.pwd",
                 "fs.rm /sh/made", "fs.rm /sh/nope", "fs.tree /"):
        sh(line)
    line = "fs.meta.cat /sh/renamed.txt"
    out.append((line, _mask_json(run(env, line))))
    dump = str(tmp_path / f"{shell}_meta.ndjson")
    sh(f"fs.meta.save -o {dump} /sh")
    out[-1] = (out[-1][0].split()[0], out[-1][1].replace(dump, "<dump>"))
    out.append(("dump", _mask_dump(dump)))
    fs2 = filer_cls(c.master.url, telemetry_interval=0)
    fs2.start()
    try:
        sh(f"fs.meta.load -filer {fs2.url} -i {dump}")
        out[-1] = (out[-1][0].split()[0],
                   out[-1][1].replace(dump, "<dump>"))
        out.append(("loaded", [port_http.request(
            "GET", f"{fs2.url}{p}") for p in
            ("/sh/renamed.txt", "/sh/sub/b.txt", "/sh/sub/deep/c.bin")]))
    finally:
        fs2.stop()
    sh("fs.rm -r /sh")
    sh("fs.ls /sh")
    sh("fs.nope")
    return out


@pytest.fixture(scope="module")
def baseline(stacks, tmp_path_factory):
    return _script("ref", stacks["ref"], tmp_path_factory.mktemp("base"))


@pytest.mark.parametrize("stack", ["ref", "port"])
@pytest.mark.parametrize("shell", ["ref", "port"])
def test_fs_commands_match_reference(shell, stack, stacks, baseline,
                                     tmp_path):
    got = _script(shell, stacks[stack], tmp_path)
    for a, b in zip(got, baseline):
        assert a == b  # the first line that differs
    assert got == baseline
    lines = dict((k, v) for k, v in got if isinstance(k, str))
    assert lines["fs.cat /sh/renamed.txt"] == "AAAA"
    assert "3 files" in lines["fs.du /sh"]
    assert lines["fs.nope"] == "ValueError"


def _fold(mf, entry_mod, n, batch):
    blobs = {}

    def upload(blob):
        fid = f"m,{len(blobs):08x}"
        blobs[fid] = blob
        return fid

    chunks = [entry_mod.FileChunk(file_id=f"1,{i:08x}", offset=i * 10,
                                  size=10 + i % 3, mtime=i % 7,
                                  is_chunk_manifest=False)
              for i in range(n)]
    folded = mf.maybe_manifestize(upload, chunks, batch=batch)
    back = mf.resolve_chunk_manifest(lambda fid: blobs[fid], folded)
    return ([c.to_dict() for c in folded], blobs,
            [c.to_dict() for c in back])


@pytest.mark.parametrize("n,batch", [(0, 10), (10, 10), (11, 10),
                                     (25, 10), (21, 10), (3000, 1000)])
def test_manifest_fold_and_resolve_equal(n, batch):
    got = _fold(port_mf, port_entry, n, batch)
    assert got == _fold(ref_mf, ref_entry, n, batch)
    folded, _, back = got
    assert sorted(c["file_id"] for c in back) == [
        f"1,{i:08x}" for i in range(n)]
    if n > batch:
        assert any(c["is_chunk_manifest"] for c in folded)


def test_manifest_nesting_limit_equal():
    def nest(mf, entry_mod):
        fc = entry_mod.FileChunk(file_id="m,0", offset=0, size=1,
                                 is_chunk_manifest=True)
        doc = json.dumps({"chunks": [fc.to_dict()]}).encode()
        try:
            mf.resolve_chunk_manifest(lambda fid: doc, [fc])
        except ValueError as e:
            return str(e)

    assert nest(port_mf, port_entry) == nest(ref_mf, ref_entry)
    assert "too deep" in nest(port_mf, port_entry)


@pytest.mark.parametrize("stack", ["ref", "port"])
def test_manifest_end_to_end(stack, stacks):
    c, fs = stacks[stack]
    data = np.random.default_rng(41).integers(
        0, 256, 20_000, dtype=np.uint8).tobytes()
    port_http.request("POST", f"{fs.url}/huge/blob.bin", data)
    entry = fs.filer.find_entry("/huge/blob.bin")
    assert sum(ch.is_chunk_manifest for ch in entry.chunks) == 4
    assert len(entry.chunks) == 4  # 20 chunks of 1,024 bytes, 5 a manifest
    assert port_http.request("GET", f"{fs.url}/huge/blob.bin") == data
    assert port_http.request("GET", f"{fs.url}/huge/blob.bin", headers={
        "Range": "bytes=5000-15000"}) == data[5000:15001]
    port_http.request("DELETE", f"{fs.url}/huge/blob.bin")
