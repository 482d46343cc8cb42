"""The port's ``weed`` CLI (``command/cli.py``, run as ``python -m
seaweedfs_tpu_torch``) held against the reference's on the CPU.

(a) In process, ``main([...])`` of each package: the same help text for
    every subcommand (``volume`` and ``server`` add ``-device``), the
    same ``version`` and ``scaffold`` output, and ``fix``, ``compact``,
    ``export`` and ``backup`` leaving the same bytes on disk. The
    gateway tiers (``s3``, ``server -s3``, ``filer.sync``,
    ``filer.replicate``, ``webdav``, ``mount`` and ``msgBroker``) start
    as child processes and answer (``mount`` through a kernel mount
    where ``/dev/fuse`` exists, else failing as the reference's does);
    ``volume`` and ``server`` with no card and
    no ``-device cpu`` raise before they start anything; ``filer``
    refuses a bad ``-shard`` as the reference does.
(b) In subprocesses, ``weed server`` of each package (the port's with
    ``-device cpu``) on a pinned record clock, then each package's
    ``upload``, ``shell -c "lock; ec.encode ..."`` and ``download``: the
    same fids, shards and ``.ecx`` byte for byte, every file downloaded
    byte-exact. ``weed server -filer`` of each package, then its
    ``filer.copy`` and ``filer.cat``: the same output and the same bytes.
"""

import contextlib
import hashlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from seaweedfs_tpu.command import cli as ref_cli  # noqa: E402
from seaweedfs_tpu_torch.command import cli as port_cli  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402
from seaweedfs_tpu_torch.storage import needle as needle_mod  # noqa: E402
from seaweedfs_tpu_torch.storage.volume import Volume  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"ref": ref_cli, "port": port_cli}
SUBCOMMANDS = (
    "version", "master", "volume", "filer", "s3", "webdav", "server",
    "shell", "benchmark", "upload", "download", "filer.copy", "filer.cat",
    "filer.meta.tail", "fix", "compact", "export", "backup", "scaffold",
    "mount", "msgBroker", "filer.sync", "filer.replicate", "scale",
    "trends")
NOT_PORTED = (
    ["s3"], ["webdav"], ["mount", "-dir", "x"], ["msgBroker"],
    ["filer.sync", "-a", "a:1", "-b", "b:1"],
    ["filer.replicate", "-filer", "a:1", "-sink.dir", "x"],
    ["server", "-s3"])


def _run(which, argv):
    """(return code or exception, stdout) of one package's ``main``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = CLIS[which].main(argv)
        except SystemExit as e:
            rc = f"exit {e.code}"
    return rc, out.getvalue()


# -- (a) in process ------------------------------------------------------------


@pytest.mark.parametrize("cmd", (None,) + SUBCOMMANDS)
def test_help_matches_reference(cmd):
    argv = ["-h"] if cmd is None else [cmd, "-h"]
    got = {which: _run(which, argv) for which in CLIS}
    if cmd in ("volume", "server"):
        port = got["port"][1]
        assert "-device DEVICE" in port and "-device" not in got["ref"][1]
        # the reference's options, and the port's one addition
        opts = port.split("options:", 1)[1].splitlines()
        start = next(i for i, ln in enumerate(opts)
                     if ln.startswith("  -device DEVICE"))
        end = next((i for i in range(start + 1, len(opts))
                    if opts[i].startswith("  -")), len(opts))
        kept = opts[:start] + opts[end:]
        assert " ".join(" ".join(kept).split()) == " ".join(
            got["ref"][1].split("options:", 1)[1].split())
        return
    assert got["port"] == got["ref"]
    assert got["port"][0] == "exit 0"


def test_version_matches_reference():
    assert _run("port", ["version"]) == _run("ref", ["version"]) == (
        0, "seaweedfs-tpu version 0.1.0\n")


@pytest.mark.parametrize("config", ("filer", "master", "security",
                                    "replication", "shell", "backend"))
def test_scaffold_matches_reference(config):
    got = _run("port", ["scaffold", "-config", config])
    assert got == _run("ref", ["scaffold", "-config", config])
    assert got[0] == 0 and got[1].startswith("{")


@pytest.mark.parametrize("argv", NOT_PORTED, ids=lambda a: " ".join(a[:1]
                                                                    + a[1:2]))
def test_unported_tiers_raise(argv, tmp_path, filers):
    """Every tier that raised before it was ported (the last three, the
    WebDAV gateway, the mount and the broker, included) now starts and
    answers."""
    _tier_answers(argv[0] + (" -s3" if argv[0] == "server" else ""),
                  tmp_path, filers)


@pytest.fixture(scope="module")
def filers(tmp_path_factory):
    """One port cluster on the CPU with a filer, and a second filer on
    the same master: the sources and targets of the tier subcommands."""
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.harness import ClusterHarness

    root = tmp_path_factory.mktemp("tiers")
    with ClusterHarness(n_volume_servers=1, volumes_per_server=8,
                        root=str(root), device="cpu",
                        with_filer=True) as c:
        c.wait_for_nodes(1)
        second = FilerServer(c.master.url, telemetry_interval=0)
        second.start()
        try:
            yield c.filer.url, second.url
        finally:
            second.stop()


def _wait(what, probe, proc, log, timeout=120.0):
    deadline = time.time() + timeout
    while True:
        try:
            got = probe()
            if got:
                return got
        except OSError:
            pass
        assert proc.poll() is None, log.read_text()[-3000:]
        assert time.time() < deadline, f"{what}: " + log.read_text()[-3000:]
        time.sleep(0.1)


def _get(url, data=None, method=None):
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def _tier_answers(what, tmp_path, filers):
    """Start ``weed <what>`` of the port as a child process and drive it
    until it answers: an object through the S3 gateway, a file written
    on the source filer read back from the sync's target, a file PUT
    through WebDAV, a message published to the broker, or a file
    written through the kernel mount, each read back."""
    src, dst = filers
    name = f"f-{what.split()[0].replace('.', '-')}.txt"
    body = what.encode() * 50
    mnt = tmp_path / "mnt"
    if what == "mount" and not os.path.exists("/dev/fuse"):
        _mount_fails_as_reference(src, tmp_path)
        return
    argv = {
        "s3": ["s3", "-filer", src, "-port", str(_free_port())],
        "server -s3": ["server", "-dir", str(tmp_path / "d"), "-device",
                       "cpu", "-master.port", str(_free_port()),
                       "-volume.port", str(_free_port()), "-filer.port",
                       str(_free_port()), "-s3", "-s3.port",
                       str(_free_port())],
        "filer.sync": ["filer.sync", "-a", src, "-b", dst, "-oneWay",
                       "-pollSeconds", "0.1"],
        "filer.replicate": ["filer.replicate", "-filer", src,
                            "-sink.dir", str(tmp_path / "sink"),
                            "-pollSeconds", "0.1"],
        "webdav": ["webdav", "-filer", src, "-port", str(_free_port())],
        "msgBroker": ["msgBroker", "-filer", src, "-port",
                      str(_free_port())],
        "mount": ["mount", "-filer", src, "-dir", str(mnt),
                  "-filer.path", "/mnt-cli"],
    }[what]
    (tmp_path / "d").mkdir()
    mnt.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO,
               SEAWEEDFS_LOAD_JSON=str(tmp_path / "none.json"))
    log = tmp_path / "weed.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "seaweedfs_tpu_torch"] + argv,
            cwd=str(tmp_path), env=env, stdout=out,
            stderr=subprocess.STDOUT)
    try:
        if what.startswith("s3") or what == "server -s3":
            s3 = f"http://127.0.0.1:{argv[argv.index('-s3.port') + 1]}" \
                if what == "server -s3" else \
                f"http://127.0.0.1:{argv[argv.index('-port') + 1]}"
            _wait(what, lambda: _get(f"{s3}/b", b"", "PUT") == b"", proc,
                  log)
            _get(f"{s3}/b/{name}", body, "PUT")
            assert _get(f"{s3}/b/{name}") == body
            assert b"SeaweedFS_s3_request_total" in _get(f"{s3}/metrics")
        elif what == "webdav":
            dav = f"http://127.0.0.1:{argv[argv.index('-port') + 1]}"
            _wait(what, lambda: _get(f"{dav}/", method="OPTIONS") == b"",
                  proc, log)
            _get(f"{dav}/cli/{name}", body, "PUT")
            assert _get(f"{dav}/cli/{name}") == body
            assert _get(f"http://{src}/cli/{name}") == body
        elif what == "msgBroker":
            b = f"http://127.0.0.1:{argv[argv.index('-port') + 1]}"
            _wait(what, lambda: _get(f"{b}/cluster"), proc, log)
            out = json.loads(_get(f"{b}/publish", json.dumps(
                {"topic": "cli", "key": name, "value": body.decode()}
            ).encode(), "POST"))
            got = json.loads(_get(
                f"{b}/subscribe?topic=cli&partition={out['partition']}"
                f"&offset={out['offset']}"))
            assert [m["value"] for m in got["messages"]] == [body.decode()]
        elif what == "mount":
            _wait(what, lambda: os.path.ismount(mnt), proc, log)
            (mnt / name).write_bytes(body)
            assert _get(f"http://{src}/mnt-cli/{name}") == body
            assert (mnt / name).read_bytes() == body
            subprocess.run(["fusermount", "-u", str(mnt)],
                           capture_output=True)
            proc.wait(timeout=30)
            return
        else:
            _get(f"http://{src}/cli/{name}", body, "POST")
            if what == "filer.sync":
                got = _wait(what, lambda: _get(f"http://{dst}/cli/{name}"),
                            proc, log)
            else:
                sunk = tmp_path / "sink" / "cli" / name
                got = _wait(what, lambda: sunk.exists()
                            and sunk.read_bytes(), proc, log)
            assert got == body
        assert proc.poll() is None, log.read_text()[-3000:]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def _mount_fails_as_reference(src, tmp_path):
    """Without ``/dev/fuse`` each package's ``weed mount`` fails alike."""
    got = {}
    for which in CLIS:
        mnt = tmp_path / f"mnt-{which}"
        mnt.mkdir()
        try:
            got[which] = ("rc", _run(which, ["mount", "-filer", src,
                                             "-dir", str(mnt)]))
        except Exception as e:  # noqa: BLE001 - the class is compared
            got[which] = ("raised", type(e).__name__)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("shard", ["x", "1", "2/2", "0/65", "a/b"])
def test_filer_bad_shard_matches_reference(shard):
    argv = ["filer", "-shard", shard]
    assert _run("port", argv) == _run("ref", argv)
    assert _run("port", argv)[0] == 1


@pytest.mark.parametrize("cmd", ["volume", "server"])
def test_servers_need_a_card_or_cpu(cmd, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [cmd, "-dir", str(tmp_path), "-ip", "127.0.0.1"]
    argv += (["-port", "0"] if cmd == "volume"
             else ["-master.port", "0", "-volume.port", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_cli.main(argv)
    with pytest.raises(ValueError, match="unsupported device"):
        port_cli.main(argv + ["-device", "mps"])


def _make_volume(root, vid):
    v = Volume(str(root), "", vid)
    rng = np.random.default_rng(vid)
    for i in range(1, 13):
        nd = needle_mod.Needle(cookie=7, id=i, data=rng.bytes(100 * i))
        nd.set_name(f"file{i}.txt".encode())
        v.write_needle(nd)
    for i in (2, 5, 9):
        v.delete_needle(i)
    v.close()


@pytest.fixture
def volumes(tmp_path, monkeypatch):
    """A volume written once, copied into a directory per package."""
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_000)
    src = tmp_path / "src"
    src.mkdir()
    _make_volume(src, 3)
    dirs = {}
    for which in CLIS:
        dirs[which] = tmp_path / which
        shutil.copytree(src, dirs[which])
    return dirs


def _files(root):
    return {p: open(os.path.join(root, p), "rb").read()
            for p in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, p))}


def _text(which, argv, dirs):
    rc, out = _run(which, argv)
    return rc, out.replace(str(dirs[which]), "<dir>")


def test_fix_matches_reference(volumes):
    got = {}
    for which, d in volumes.items():
        v = Volume(str(d), "", 3)
        want = v.read_needle(4).data
        v.close()
        log = (d / "3.idx").read_bytes()
        (d / "3.idx").unlink()
        got[which] = _text(which, ["fix", "-dir", str(d), "-volumeId", "3"],
                           volumes)
        got[which] += (_files(d),)
        # the scan keeps each live needle and drops the deleted ones
        v = Volume(str(d), "", 3)
        try:
            assert v.read_needle(4).data == want
            with pytest.raises(KeyError):
                v.read_needle(5)
        finally:
            v.close()
        assert len((d / "3.idx").read_bytes()) < len(log)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (0, "rebuilt <dir>/3.idx with 9 entries\n")


def test_compact_matches_reference(volumes):
    before = os.path.getsize(volumes["port"] / "3.dat")
    got = {which: _text(which, ["compact", "-dir", str(d), "-volumeId",
                                "3"], volumes) + (_files(d),)
           for which, d in volumes.items()}
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (0, "compacted volume 3\n")
    assert os.path.getsize(volumes["port"] / "3.dat") < before


def test_export_matches_reference(volumes):
    got = {}
    for which, d in volumes.items():
        out = d / "exported"
        got[which] = _text(which, ["export", "-dir", str(d), "-volumeId",
                                   "3", "-o", str(out)], volumes)
        got[which] += (_files(out),)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (0, "exported 9 files to <dir>/exported\n")
    assert "file2.txt" not in got["port"][2] and len(got["port"][2]) == 9


def test_backup_matches_reference(tmp_path, monkeypatch):
    clock = iter(range(1_700_000_000_000_000_000, 1 << 62, 1000))
    monkeypatch.setattr(time, "time_ns", lambda: next(clock))
    vs = VolumeServer("http://127.0.0.1:9", [str(tmp_path / "src")],
                      pulse_seconds=60, device="cpu")
    vs.start()
    try:
        from seaweedfs_tpu_torch.util import http
        http.post_json(f"{vs.url}/admin/assign_volume",
                       {"volume": 6, "collection": "bk"})

        def write(keys):
            for k in keys:
                http.request("POST", f"{vs.url}/6,{k:x}{0xabc0 + k:08x}"
                             "?ts=1700000000", bytes([k]) * 333 * k)

        write(range(1, 5))
        outs = {which: [] for which in CLIS}
        dirs = {which: tmp_path / which for which in CLIS}
        argv = ["backup", "-server", vs.url, "-collection", "bk",
                "-volumeId", "6", "-dir"]
        for which in CLIS:
            outs[which].append(_text(which, argv + [str(dirs[which])],
                                     dirs))
        write(range(5, 8))
        http.request("DELETE", f"{vs.url}/6,{2:x}{0xabc2:08x}")
        for which in CLIS:
            outs[which].append(_text(which, argv + [str(dirs[which])],
                                     dirs))
            outs[which].append(_text(which, argv + [str(dirs[which])],
                                     dirs))
        assert outs["port"] == outs["ref"]
        src = _files(tmp_path / "src")
        for which in CLIS:
            assert _files(dirs[which])["bk_6.dat"] == src["bk_6.dat"]
        assert outs["port"][2] == (0, "backed up volume 6: 0 new bytes\n")
    finally:
        vs.stop()


# -- (b) weed server, upload, shell ec.encode, download ---------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WEEDS = {"ref": [sys.executable, os.path.join(REPO, "weed.py")],
         "port": [sys.executable, "-m", "seaweedfs_tpu_torch"]}


def _weed_run(which, tmp_path, paths):
    """One package's ``weed server`` (pinned clock, seeded draws) driven
    by that package's ``upload``, ``shell`` and ``download``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               SEAWEEDFS_LOAD_JSON=str(tmp_path / "none.json"))
    root = tmp_path / which
    data = root / "data"
    data.mkdir(parents=True)
    mport, vport = _free_port(), _free_port()
    master = f"127.0.0.1:{mport}"
    argv = [sys.executable, os.path.join(REPO, "tests", "_torch_weed_child.py"),
            which, "server", "-dir", str(data), "-master.port", str(mport),
            "-volume.port", str(vport), "-volume.max", "30"]
    if which == "port":
        argv += ["-device", "cpu"]
    with open(root / "server.log", "wb") as log:
        srv = subprocess.Popen(argv, cwd=str(root), env=env, stdout=log,
                               stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://{master}/dir/status", timeout=5) as r:
                    status = json.load(r)
                if any(rack["data_nodes"] for dc in status["data_centers"]
                       for rack in dc["racks"]):
                    break
            except OSError:
                pass
            assert srv.poll() is None, (root / "server.log").read_text()
            assert time.time() < deadline, "weed server never came up"
            time.sleep(0.1)

        def weed(*args):
            p = subprocess.run(WEEDS[which] + list(args), cwd=str(root),
                               env=env, capture_output=True, text=True,
                               timeout=300)
            assert p.returncode == 0, p.stderr[-3000:]
            return p.stdout

        uploaded = [json.loads(line) for line in
                    weed("upload", "-master", master, *paths).splitlines()]
        fids = [u["fid"] for u in uploaded]
        vids = [int(f.split(",")[0]) for f in fids]
        vid = max(set(vids), key=vids.count)
        shell = weed("shell", "-master", master, "-c",
                     f"lock; ec.encode -volumeId {vid} -quietFor 0s; "
                     "volume.fsck; unlock")
        (root / "dl").mkdir()
        down = weed("download", "-master", master, "-dir",
                    str(root / "dl"), *fids)
        shards = {n: hashlib.sha256((data / n).read_bytes()).hexdigest()
                  for n in sorted(os.listdir(data)) if ".ec" in n}
        files = {f: (root / "dl" / f.replace(",", "_")).read_bytes()
                 for f in fids}
        return {"uploaded": uploaded, "vid": vid, "shards": shards,
                "files": files,
                # server URLs named by role, the measured phase line out
                "shell": [ln.replace(master, "<master>").replace(
                    f"127.0.0.1:{vport}", "<vs>")
                    for ln in shell.splitlines() if ": phases " not in ln],
                "download": down.replace(str(root), "<root>")}
    finally:
        srv.terminate()
        try:
            srv.wait(30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()


def test_weed_server_upload_encode_download_matches_reference(tmp_path):
    files = tmp_path / "files"
    files.mkdir()
    paths = []
    for i in range(14):
        p = files / f"f{i:02d}.bin"
        p.write_bytes(np.random.default_rng([16, i]).bytes(
            150_000 + 37_000 * i))
        paths.append(str(p))
    got = {which: _weed_run(which, tmp_path, paths) for which in WEEDS}
    assert got["port"] == got["ref"]
    run = got["port"]
    for u, path in zip(run["uploaded"], paths):
        assert run["files"][u["fid"]] == open(path, "rb").read()
    vid = run["vid"]
    assert sorted(run["shards"]) == sorted(
        [f"{vid}.ec{s:02d}" for s in range(14)] + [f"{vid}.ecx"])
    # data on more than one data shard, and parity that is not zero
    assert len({run["shards"][f"{vid}.ec{s:02d}"] for s in range(14)}) > 5
    assert f"volume {vid}: ec.encode done" in run["shell"]
    assert run["shell"][-2:] == ["checked 9 needles, 0 issues", "unlocked"]


def _filer_run(which, tmp_path, paths):
    """One package's ``weed server -filer``, then its ``filer.copy`` of
    ``paths`` and ``filer.cat`` of each copy."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               SEAWEEDFS_LOAD_JSON=str(tmp_path / "none.json"))
    root = tmp_path / f"filer_{which}"
    data = root / "data"
    data.mkdir(parents=True)
    mport, vport, fport = _free_port(), _free_port(), _free_port()
    filer = f"127.0.0.1:{fport}"
    argv = WEEDS[which] + [
        "server", "-dir", str(data), "-master.port", str(mport),
        "-volume.port", str(vport), "-filer", "-filer.port", str(fport)]
    if which == "port":
        argv += ["-device", "cpu"]
    with open(root / "server.log", "wb") as log:
        srv = subprocess.Popen(argv, cwd=str(root), env=env, stdout=log,
                               stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{mport}/dir/status",
                        timeout=5) as r:
                    status = json.load(r)
                if any(rack["data_nodes"] for dc in status["data_centers"]
                       for rack in dc["racks"]):
                    urllib.request.urlopen(f"http://{filer}/",
                                           timeout=5).close()
                    break
            except OSError:
                pass
            assert srv.poll() is None, (root / "server.log").read_text()
            assert time.time() < deadline, "weed server never came up"
            time.sleep(0.1)

        def weed(*args, text=True):
            p = subprocess.run(WEEDS[which] + list(args), cwd=str(root),
                               env=env, capture_output=True, text=text,
                               timeout=300)
            assert p.returncode == 0, p.stderr[-3000:]
            return p.stdout

        copied = weed("filer.copy", "-filer", filer, *paths, "/docs/in")
        cats = {os.path.basename(p): weed(
            "filer.cat", "-filer", filer,
            "/docs/in/" + os.path.basename(p), text=False)
            for p in paths}
        return copied.replace(str(tmp_path), "<tmp>"), cats
    finally:
        srv.terminate()
        try:
            srv.wait(30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()


def test_weed_server_filer_copy_cat_matches_reference(tmp_path):
    files = tmp_path / "files"
    files.mkdir()
    paths = []
    for i in range(3):
        p = files / f"doc{i}.bin"
        p.write_bytes(np.random.default_rng([17, i]).bytes(
            1 + 700_000 * i))
        paths.append(str(p))
    got = {which: _filer_run(which, tmp_path, paths) for which in WEEDS}
    assert got["port"] == got["ref"]
    copied, cats = got["port"]
    assert copied.splitlines() == [
        f"<tmp>/files/doc{i}.bin -> /docs/in/doc{i}.bin" for i in range(3)]
    for p in paths:
        assert cats[os.path.basename(p)] == open(p, "rb").read()


@pytest.mark.parametrize("module", [
    "seaweedfs_tpu_torch.shell",
    "seaweedfs_tpu_torch.shell.command_ec",
    "seaweedfs_tpu_torch.maintenance",
])
def test_shell_client_starts_without_torch(module):
    """``weed shell`` runs its commands on the servers: importing it (the
    maintenance plane and the EC constants included) loads no torch, so
    each ``weed shell -c`` starts in well under a second."""
    code = (f"import sys, {module}\n"
            "assert 'torch' not in sys.modules, "
            "[m for m in sys.modules if m.startswith('torch')][:5]\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr


def test_erasure_coding_names_resolve_at_first_use():
    """The package's encoder and rebuild names, imported lazily, are the
    same objects as the submodules' and import the way they always did."""
    from seaweedfs_tpu_torch.storage import erasure_coding as ec
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        encoder,
        rebuild,
        write_ec_files,
    )

    assert write_ec_files is encoder.write_ec_files
    assert ec.write_ec_files_batch is encoder.write_ec_files_batch
    assert ec.write_sorted_file_from_idx is encoder.write_sorted_file_from_idx
    assert ec.rebuild_ec_files is rebuild.rebuild_ec_files
    with pytest.raises(AttributeError):
        ec.no_such_name  # noqa: B018
