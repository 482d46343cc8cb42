"""The port's mount (``mount/wfs.py``, ``mount/page_writer.py``,
``mount/fuse_ctypes.py``) held against the reference's on the CPU.

One seeded ``WFS`` operation sequence (create/write/flush/release,
random-offset rewrites read through the dirty pages, a truncate, a
rename, a symlink, a hard link, xattrs, unlink, directories and their
errors) runs on each package's ``WFS`` over its own cluster and filer:
the same answers, every file read back through a fresh ``WFS`` alike,
and the same filer entries, with chunk ids, hard-link ids and
wall-clock times masked. ``IntervalPages`` and ``PageWriter`` give the
same spans and chunks on a seeded scattered-write schedule. The port's
``close()`` joins its meta-subscription threads, after the
subscription has made an external write visible. ``fuse_ctypes``
imports without loading libfuse. Last, a kernel mount of the port's
``WFS``, skipped without ``/dev/fuse`` as ``tests/test_mount.py`` skips.
"""

import errno
import json
import multiprocessing as mp
import os
import random
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.mount import page_writer as ref_pw  # noqa: E402
from seaweedfs_tpu.mount import wfs as ref_wfs  # noqa: E402
from seaweedfs_tpu.server.harness import (  # noqa: E402
    ClusterHarness as RefHarness,
)
from seaweedfs_tpu_torch.mount import page_writer as port_pw  # noqa: E402
from seaweedfs_tpu_torch.mount import wfs as port_wfs  # noqa: E402
from seaweedfs_tpu_torch.server.harness import (  # noqa: E402
    ClusterHarness as PortHarness,
)
from seaweedfs_tpu_torch.util import http  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WFS = {"ref": ref_wfs, "port": port_wfs}
MASKED = ("mtime", "crtime", "Mtime", "Crtime", "hard_link_id",
          "HardLinkId", "ts_ns", "modified_ts_ns")


@pytest.fixture(scope="module")
def filers(tmp_path_factory):
    root = tmp_path_factory.mktemp("mount")
    with RefHarness(n_volume_servers=1, volumes_per_server=12,
                    root=str(root / "ref"), with_filer=True) as ref, \
            PortHarness(n_volume_servers=1, volumes_per_server=12,
                        root=str(root / "port"), device="cpu",
                        with_filer=True) as port:
        ref.wait_for_nodes(1)
        port.wait_for_nodes(1)
        yield {"ref": ref.filer.url, "port": port.filer.url}


def _masked(obj, fids):
    """Times and link ids masked; chunk ids by order of appearance."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in MASKED:
                out[k] = "<masked>"
            elif k in ("file_id", "fid") and isinstance(v, str):
                out[k] = fids.setdefault(v, f"<fid {len(fids)}>")
            else:
                out[k] = _masked(v, fids)
        return out
    if isinstance(obj, list):
        return [_masked(v, fids) for v in obj]
    return obj


def _attrs(w, path):
    try:
        a = w.getattr(path)
    except OSError as e:
        return ("error", e.errno)
    return {k: v for k, v in a.items() if k != "st_mtime"}


def _err(fn, *args):
    try:
        return ("ok", fn(*args))
    except OSError as e:
        return ("error", e.errno)


def _sequence(mod, filer_url, seed):
    """One seeded operation sequence through a ``WFS`` of ``mod`` under
    its own root; then every file back through a fresh ``WFS``, and the
    filer's entries."""
    rng = np.random.default_rng(seed)
    root = f"/wfs{seed}"
    out = []
    w = mod.WFS(filer_url, filer_root=root, chunk_size=64 * 1024,
                subscribe_meta=False)
    mirror: dict[str, bytearray] = {}
    try:
        w.mkdir("/d", 0o755)
        w.mkdir("/d/sub", 0o755)
        for i in range(6):
            path = f"/d/f{i}"
            size = int(rng.integers(10_000, 300_000))
            data = rng.bytes(size)
            fh = w.create(path, 0o644)
            pos = 0
            while pos < size:  # the kernel's pieces: up to 128 KiB
                n = min(size - pos, int(rng.integers(1, 128 * 1024)))
                out.append(w.write(path, data[pos:pos + n], pos, fh))
                pos += n
            w.flush(path, fh)
            w.release(path, fh)
            mirror[path] = bytearray(data)
        # random-offset rewrites, read through the dirty pages
        fh = w.open("/d/f0", os.O_RDWR)
        buf = mirror["/d/f0"]
        for _ in range(8):
            off = int(rng.integers(0, len(buf) - 1000))
            patch = rng.bytes(int(rng.integers(1, 40_000)))
            w.write("/d/f0", patch, off, fh)
            buf[off:off + len(patch)] = patch
            lo = int(rng.integers(0, len(buf) - 500))
            got = w.read("/d/f0", 4000, lo, fh)
            out.append(got == bytes(buf[lo:lo + 4000]))
            out.append(_attrs(w, "/d/f0"))
        w.flush("/d/f0", fh)
        w.release("/d/f0", fh)
        # an append past the end, a truncate, a grow
        fh = w.open("/d/f1", os.O_WRONLY)
        tail = rng.bytes(5000)
        w.write("/d/f1", tail, len(mirror["/d/f1"]), fh)
        mirror["/d/f1"] += tail
        w.release("/d/f1", fh)
        half = len(mirror["/d/f1"]) // 2
        w.truncate("/d/f1", half)
        del mirror["/d/f1"][half:]
        w.truncate("/d/f2", len(mirror["/d/f2"]) + 777)
        mirror["/d/f2"] += bytes(777)
        w.rename("/d/f3", "/d/sub/g3")
        mirror["/d/sub/g3"] = mirror.pop("/d/f3")
        w.symlink("/d/f0", "/d/link")
        out.append(w.readlink("/d/link"))
        out.append(_err(w.readlink, "/d/f0"))
        w.link("/d/f4", "/d/hard4")
        mirror["/d/hard4"] = mirror["/d/f4"]
        for name, value in (("color", b"blue"),
                            ("blob", bytes(range(256)))):
            w.setxattr("/d/f5", name, value, 0)
        out.append(_err(w.setxattr, "/d/f5", "color", b"x",
                        port_wfs.XATTR_CREATE))
        out.append(_err(w.setxattr, "/d/f5", "nope", b"x",
                        port_wfs.XATTR_REPLACE))
        out.append(w.getxattr("/d/f5", "blob"))
        w.removexattr("/d/f5", "color")
        out.append(sorted(w.listxattr("/d/f5")))
        out.append(_err(w.getxattr, "/d/f5", "color"))
        w.unlink("/d/f2")
        del mirror["/d/f2"]
        out.append(_err(w.unlink, "/d/missing"))
        out.append(_err(w.rmdir, "/nowhere"))
        out.append(sorted(w.readdir("/d")))
        out.append(sorted(w.readdir("/d/sub")))
        for path in sorted(mirror) + ["/d", "/d/link", "/d/f2", "/"]:
            out.append((path, _attrs(w, path)))
    finally:
        w.close()
    # a fresh WFS reads every byte back, whole and in ranges
    fresh = mod.WFS(filer_url, filer_root=root, subscribe_meta=False)
    try:
        for path, data in sorted(mirror.items()):
            whole = fresh.read(path, len(data) + 100, 0, 0)
            out.append((path, whole == bytes(data), len(whole)))
            for _ in range(3):
                lo = int(rng.integers(0, len(data)))
                n = int(rng.integers(1, 70_000))
                got = fresh.read(path, n, lo, 0)
                out.append(got == bytes(data[lo:lo + n]))
        out.append(fresh.read("/d/f0", 10, len(mirror["/d/f0"]) + 5, 0))
    finally:
        fresh.close()
    fids: dict = {}
    for path in sorted(mirror) + ["/d/link"]:
        meta = http.get_json(f"{filer_url}{root}{path}?meta=true")
        out.append((path, _masked(meta, fids)))
    listing = http.get_json(f"{filer_url}{root}/d/?limit=100")
    out.append(_masked(listing, fids))
    return out


@pytest.mark.parametrize("seed", [3, 8])
def test_wfs_sequence_matches_reference(filers, seed):
    got = {name: _sequence(mod, filers[name], seed)
           for name, mod in WFS.items()}
    assert len(got["port"]) == len(got["ref"])
    for i, (port, ref) in enumerate(zip(got["port"], got["ref"])):
        assert port == ref, (i, port)
    # every read in the sequence and after it was byte-exact
    flags = [x for x in got["port"] if isinstance(x, bool)]
    assert flags and all(flags)
    assert all(x[1] for x in got["port"]
               if isinstance(x, tuple) and len(x) == 3
               and isinstance(x[1], bool))
    assert ("error", errno.EINVAL) in got["port"]


def _pages(mod, seed):
    """A seeded scattered-write schedule through ``IntervalPages`` and a
    ``PageWriter`` whose uploads are recorded: spans, reads, chunks."""
    rng = random.Random(seed)
    pages = mod.IntervalPages()
    out = []
    for _ in range(300):
        off = rng.randrange(0, 1 << 20)
        data = rng.randbytes(rng.randrange(1, 9000))
        pages.write(off, data)
        if rng.random() < 0.2:  # a sequential follower: the fast path
            pages.write(off + len(data), rng.randbytes(100))
        lo = rng.randrange(0, 1 << 20)
        out.append((pages.covers(lo, 64), pages.total_bytes(),
                    pages.extent()))
        if pages.covers(lo, 64):
            out.append(pages.read(lo, 64))
    out.append([(s, bytes(b)) for s, b in pages.intervals])
    uploads = []

    def upload(data):
        uploads.append(data)
        return f"1,{len(uploads):x}"

    pw = mod.PageWriter(upload, chunk_size=32 * 1024)
    for _ in range(400):
        if rng.random() < 0.5:
            off = pw.extent
        else:
            off = rng.randrange(0, max(1, pw.extent + 1))
        pw.write(off, rng.randbytes(rng.randrange(1, 20_000)))
        out.append((len(uploads), pw.pages.total_bytes(), pw.extent,
                    pw.dirty()))
    chunks = pw.chunks + pw.flush()
    out.append([(c["file_id"], c["offset"], c["size"]) for c in chunks])
    out.append(uploads)
    out.append((pw.dirty(), pw.pages.intervals))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_writer_matches_reference(seed):
    assert _pages(port_pw, seed) == _pages(ref_pw, seed)


def test_close_joins_the_meta_subscription(filers):
    """An external write becomes visible through the subscription; the
    port's ``close()`` then joins every meta thread."""
    url = filers["port"]
    http.request("POST", f"{url}/sub/x.bin", b"1" * 10)
    w = port_wfs.WFS(url, filer_root="/sub")
    try:
        assert len(w._meta_threads) == 1
        # only a pushed event can refresh a cached attr now
        w._cache_ttl = float("inf")
        assert w.getattr("/x.bin")["st_size"] == 10
        deadline = time.monotonic() + 120
        while w.getattr("/x.bin")["st_size"] != 33:
            # rewritten until one write lands after the subscription's
            # cursor is set
            assert time.monotonic() < deadline, "no meta invalidation"
            http.request("POST", f"{url}/sub/x.bin", b"2" * 33)
            time.sleep(0.2)
    finally:
        closer = threading.Thread(target=w.close)
        closer.start()
        # an event ends the long-poll in flight at once
        http.request("POST", f"{url}/sub/wake.bin", b"w")
        closer.join(timeout=60)
    assert not closer.is_alive()
    assert not any(t.is_alive() for t in w._meta_threads)


def test_fuse_ctypes_imports_without_libfuse():
    """Importing the binding loads no library: only a mount does."""
    code = (
        "import ctypes, sys\n"
        "loaded = []\n"
        "real = ctypes.CDLL.__init__\n"
        "def spy(self, name, *a, **k):\n"
        "    loaded.append(name)\n"
        "    return real(self, name, *a, **k)\n"
        "ctypes.CDLL.__init__ = spy\n"
        "import seaweedfs_tpu_torch.mount.fuse_ctypes as f\n"
        "import seaweedfs_tpu_torch.mount\n"
        "assert hasattr(f, 'FUSE') and not [n for n in loaded "
        "if n and 'fuse' in str(n)], loaded\n"
        "assert 'torch' not in sys.modules\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr


def _run_mount(filer_url, mnt):
    from seaweedfs_tpu_torch.mount import mount_filer

    mount_filer(filer_url, mnt, chunk_size=2 * 1024 * 1024)


@pytest.fixture
def mounted(filers):
    if not os.path.exists("/dev/fuse"):
        pytest.skip("no /dev/fuse")
    mnt = tempfile.mkdtemp(prefix="swtpu_torch_mnt_")
    proc = mp.get_context("spawn").Process(
        target=_run_mount, args=(filers["port"], mnt), daemon=True)
    proc.start()
    deadline = time.time() + 60
    while time.time() < deadline and not os.path.ismount(mnt):
        if not proc.is_alive():
            break
        time.sleep(0.2)
    if not os.path.ismount(mnt):
        proc.terminate()
        pytest.skip("mount did not come up (sandboxed?)")
    try:
        yield filers["port"], mnt
    finally:
        subprocess.run(["fusermount", "-u", mnt], capture_output=True)
        proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()


def test_kernel_mount_of_the_port(mounted):
    """The reference's mount cases through a kernel mount of the port's
    ``WFS``: writes visible in the filer, directories, random-offset
    rewrites, append and truncate, xattrs and a symlink."""
    url, mnt = mounted
    rng = np.random.default_rng(7)
    with open(f"{mnt}/hello.txt", "wb") as f:
        f.write(b"fuse!")
    assert http.request("GET", f"{url}/hello.txt") == b"fuse!"
    os.mkdir(f"{mnt}/fdir")
    with open(f"{mnt}/fdir/a.bin", "wb") as f:
        f.write(b"abc")
    os.rename(f"{mnt}/fdir/a.bin", f"{mnt}/fdir/b.bin")
    assert os.listdir(f"{mnt}/fdir") == ["b.bin"]
    size = 5 * 1024 * 1024  # three chunks at 2 MiB
    mirror = bytearray(rng.integers(0, 256, size=size,
                                    dtype=np.uint8).tobytes())
    with open(f"{mnt}/rw.bin", "wb") as f:
        f.write(bytes(mirror))
    for _ in range(6):
        off = int(rng.integers(0, size - 200_000))
        patch = rng.integers(0, 256, size=int(rng.integers(1, 200_000)),
                             dtype=np.uint8).tobytes()
        with open(f"{mnt}/rw.bin", "r+b") as f:
            f.seek(off)
            f.write(patch)
        mirror[off:off + len(patch)] = patch
    with open(f"{mnt}/rw.bin", "rb") as f:
        assert f.read() == bytes(mirror)
    meta = json.loads(http.request("GET", f"{url}/rw.bin?meta=true"))
    assert len(meta["chunks"]) >= 3
    with open(f"{mnt}/t.txt", "wb") as f:
        f.write(b"0123456789")
    with open(f"{mnt}/t.txt", "ab") as f:
        f.write(b"ABC")
    os.truncate(f"{mnt}/t.txt", 4)
    with open(f"{mnt}/t.txt", "rb") as f:
        assert f.read() == b"0123"
    os.setxattr(f"{mnt}/t.txt", "user.color", b"blue")
    assert os.getxattr(f"{mnt}/t.txt", "user.color") == b"blue"
    os.symlink("hello.txt", f"{mnt}/slink")
    assert os.readlink(f"{mnt}/slink") == "hello.txt"
    with open(f"{mnt}/slink", "rb") as f:
        assert f.read() == b"fuse!"
