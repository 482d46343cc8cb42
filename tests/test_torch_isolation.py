"""The port stands alone: no module of ``seaweedfs_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, anything of ``seaweedfs_tpu``, or the
reference's scripts (``bench.py``, ``tools/``)."""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "seaweedfs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "seaweedfs_tpu", "bench", "tools")


def port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_modules(path, root=REPO):
    """Absolute module names a file imports; relative imports resolved
    against the file's package under ``root``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    rel = os.path.relpath(path, root)[:-3].split(os.sep)
    package = rel[:-1]  # a module's package; __init__ is its own
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                if node.level - 1 > len(package):
                    yield "<beyond the repository>"
                    continue
                base = package[: len(package) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod
            for alias in node.names:
                yield f"{mod}.{alias.name}"


def is_forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in FORBIDDEN or mod.startswith("<")


def test_port_files_exist():
    files = port_files()
    names = {os.path.relpath(p, REPO) for p in files}
    assert "chip_smoke.py" in names
    assert os.path.join("seaweedfs_tpu_torch", "ops", "codec.py") in names
    for sweep in ("__init__", "exp_dev8", "exp_dev8b", "exp_batched"):
        assert os.path.join("seaweedfs_tpu_torch", "tools",
                            sweep + ".py") in names
    assert os.path.join("seaweedfs_tpu_torch", "ops", "timing.py") in names
    for module in (("native", "__init__.py"),
                   ("storage", "needle.py"),
                   ("storage", "super_block.py"),
                   ("storage", "backend.py"),
                   ("storage", "ec_volume.py"),
                   ("storage", "erasure_coding", "decoder.py"),
                   ("stats", "__init__.py"),
                   ("stats", "metrics.py"),
                   ("tracing", "__init__.py"),
                   ("tracing", "span.py"),
                   ("tracing", "recorder.py"),
                   ("tracing", "render.py"),
                   ("fault", "__init__.py"),
                   ("ops", "link.py"),
                   ("ops", "profiler.py"),
                   ("telemetry", "devices.py"),
                   ("parallel", "__init__.py"),
                   ("parallel", "mesh.py"),
                   ("parallel", "ec_sharded.py"),
                   ("util", "__init__.py"),
                   ("util", "http.py"),
                   ("util", "retry.py"),
                   ("util", "glog.py"),
                   ("util", "config.py"),
                   ("util", "limiter.py"),
                   ("util", "compression.py"),
                   ("pb", "__init__.py"),
                   ("pb", "messages.py"),
                   ("security", "__init__.py"),
                   ("security", "jwt.py"),
                   ("images", "__init__.py"),
                   ("images", "resizing.py"),
                   ("storage", "file_id.py"),
                   ("storage", "needle_map.py"),
                   ("storage", "volume.py"),
                   ("storage", "store.py"),
                   ("server", "__init__.py"),
                   ("server", "heartbeat_stream.py"),
                   ("server", "volume.py"),
                   ("topology", "__init__.py"),
                   ("topology", "node.py"),
                   ("topology", "volume_layout.py"),
                   ("topology", "topology.py"),
                   ("topology", "volume_growth.py"),
                   ("server", "location_watch.py"),
                   ("server", "raft.py"),
                   ("server", "master.py"),
                   ("server", "harness.py"),
                   ("security", "tls.py"),
                   ("operation", "__init__.py"),
                   ("operation", "masters.py"),
                   ("operation", "watch.py"),
                   ("operation", "client.py"),
                   ("operation", "submit.py"),
                   ("maintenance", "__init__.py"),
                   ("maintenance", "tasks.py"),
                   ("maintenance", "policy.py"),
                   ("maintenance", "ops.py"),
                   ("shell", "__init__.py"),
                   ("shell", "commands.py"),
                   ("shell", "command_ec.py"),
                   ("maintenance", "detector.py"),
                   ("maintenance", "scheduler.py"),
                   ("maintenance", "plane.py"),
                   ("telemetry", "slow.py"),
                   ("telemetry", "snapshot.py"),
                   ("telemetry", "aggregator.py"),
                   ("shell", "command_cluster.py"),
                   ("shell", "command_maintenance.py"),
                   ("util", "lockwitness.py"),
                   ("telemetry", "recorder.py"),
                   ("telemetry", "debug.py"),
                   ("telemetry", "profile.py"),
                   ("tracing", "middleware.py"),
                   ("util", "benchgate.py"),
                   ("command", "__init__.py"),
                   ("command", "benchmark.py"),
                   ("scale", "__init__.py"),
                   ("scale", "spec.py"),
                   ("scale", "harness.py"),
                   ("scale", "churn.py"),
                   ("scale", "converge.py"),
                   ("scale", "round.py"),
                   ("shell", "command_trace.py"),
                   ("shell", "command_volume.py"),
                   ("shell", "command_collection.py"),
                   ("shell", "command_fault.py"),
                   ("storage", "volume_backup.py"),
                   ("server", "ui.py"),
                   ("telemetry", "trajectory.py"),
                   ("util", "reswitness.py"),
                   ("util", "chunk_cache.py"),
                   ("util", "cipher.py"),
                   ("command", "cli.py"),
                   ("__main__.py",),
                   ("query", "__init__.py"),
                   ("query", "json_query.py"),
                   ("filer", "__init__.py"),
                   ("filer", "entry.py"),
                   ("filer", "filechunks.py"),
                   ("filer", "filechunk_manifest.py"),
                   ("filer", "filerstore.py"),
                   ("filer", "stores.py"),
                   ("filer", "log_buffer.py"),
                   ("filer", "filer.py"),
                   ("filer", "sharding", "__init__.py"),
                   ("filer", "sharding", "ring.py"),
                   ("filer", "sharding", "bench.py"),
                   ("telemetry", "reporter.py"),
                   ("server", "filer.py"),
                   ("shell", "command_fs.py"),
                   ("s3", "__init__.py"),
                   ("s3", "auth.py"),
                   ("s3", "s3api.py"),
                   ("shell", "command_s3.py"),
                   ("replication", "__init__.py"),
                   ("replication", "replicator.py"),
                   ("replication", "sink.py"),
                   ("replication", "sync.py"),
                   ("notification", "__init__.py"),
                   ("notification", "publisher.py"),
                   ("messaging", "__init__.py"),
                   ("messaging", "broker.py"),
                   ("mount", "__init__.py"),
                   ("mount", "wfs.py"),
                   ("mount", "fuse_ctypes.py"),
                   ("mount", "page_writer.py"),
                   ("server", "webdav.py"),
                   ("ftpd", "__init__.py")):
        assert os.path.join("seaweedfs_tpu_torch", *module) in names
    assert len(files) > 10


def test_no_file_imports_jax_or_the_reference_package():
    offenders = [
        (os.path.relpath(path, REPO), mod)
        for path in port_files()
        for mod in imported_modules(path)
        if is_forbidden(mod)
    ]
    assert not offenders, offenders


def test_sharding_bench_child_imports_only_the_port():
    """The sharding bench runs each shard from an embedded script, which
    the file scan does not parse: its imports name the port alone."""
    from seaweedfs_tpu_torch.filer.sharding import bench

    tree = ast.parse(bench._SHARD_MAIN)
    mods = [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)]
    assert mods == ["seaweedfs_tpu_torch.filer.stores",
                    "seaweedfs_tpu_torch.server.filer"], mods
    assert not any(is_forbidden(m) for m in mods)


def test_scan_catches_a_forbidden_import(tmp_path):
    """The scanner itself: both spellings of a reference import and a
    relative import that climbs out of the port are caught."""
    pkg = tmp_path / "seaweedfs_tpu_torch"
    pkg.mkdir()
    bad = pkg / "bad.py"
    bad.write_text(
        "import jax.numpy as jnp\n"
        "from seaweedfs_tpu.ops import gf256\n"
        "from ..seaweedfs_tpu import ops\n"
        "from bench import make_slope_timer\n"
        "import tools.exp_dev8\n"
    )
    mods = list(imported_modules(str(bad), root=str(tmp_path)))
    assert sum(is_forbidden(m) for m in mods) >= 5, mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import seaweedfs_tpu_torch.storage.erasure_coding\n"
        "import seaweedfs_tpu_torch.ops.codec\n"
        "import seaweedfs_tpu_torch.telemetry.phases\n"
        "import seaweedfs_tpu_torch.telemetry.devices\n"
        "import seaweedfs_tpu_torch.ops.link\n"
        "import seaweedfs_tpu_torch.ops.profiler\n"
        "import seaweedfs_tpu_torch.stats\n"
        "import seaweedfs_tpu_torch.tracing\n"
        "import seaweedfs_tpu_torch.fault\n"
        "import seaweedfs_tpu_torch.parallel\n"
        "import seaweedfs_tpu_torch.tools.exp_dev8\n"
        "import seaweedfs_tpu_torch.tools.exp_dev8b\n"
        "import seaweedfs_tpu_torch.tools.exp_batched\n"
        "import seaweedfs_tpu_torch.util.http\n"
        "import seaweedfs_tpu_torch.pb\n"
        "import seaweedfs_tpu_torch.security\n"
        "import seaweedfs_tpu_torch.storage.store\n"
        "import seaweedfs_tpu_torch.server.volume\n"
        "import seaweedfs_tpu_torch.server.heartbeat_stream\n"
        "import seaweedfs_tpu_torch.server.master\n"
        "import seaweedfs_tpu_torch.server.harness\n"
        "import seaweedfs_tpu_torch.security.tls\n"
        "import seaweedfs_tpu_torch.operation\n"
        "import seaweedfs_tpu_torch.maintenance.ops\n"
        "import seaweedfs_tpu_torch.shell\n"
        "import seaweedfs_tpu_torch.shell.commands\n"
        "import seaweedfs_tpu_torch.maintenance.detector\n"
        "import seaweedfs_tpu_torch.maintenance.scheduler\n"
        "import seaweedfs_tpu_torch.maintenance.plane\n"
        "import seaweedfs_tpu_torch.telemetry.slow\n"
        "import seaweedfs_tpu_torch.telemetry.snapshot\n"
        "import seaweedfs_tpu_torch.telemetry.aggregator\n"
        "import seaweedfs_tpu_torch.shell.command_cluster\n"
        "import seaweedfs_tpu_torch.shell.command_maintenance\n"
        "import seaweedfs_tpu_torch.util.lockwitness\n"
        "import seaweedfs_tpu_torch.telemetry.recorder\n"
        "import seaweedfs_tpu_torch.telemetry.debug\n"
        "import seaweedfs_tpu_torch.telemetry.profile\n"
        "import seaweedfs_tpu_torch.tracing.middleware\n"
        "import seaweedfs_tpu_torch.util.benchgate\n"
        "import seaweedfs_tpu_torch.command\n"
        "import seaweedfs_tpu_torch.command.benchmark\n"
        "import seaweedfs_tpu_torch.scale\n"
        "import seaweedfs_tpu_torch.scale.spec\n"
        "import seaweedfs_tpu_torch.scale.harness\n"
        "import seaweedfs_tpu_torch.scale.churn\n"
        "import seaweedfs_tpu_torch.scale.converge\n"
        "import seaweedfs_tpu_torch.scale.round\n"
        "import seaweedfs_tpu_torch.shell.command_trace\n"
        "import seaweedfs_tpu_torch.shell.command_volume\n"
        "import seaweedfs_tpu_torch.shell.command_collection\n"
        "import seaweedfs_tpu_torch.shell.command_fault\n"
        "import seaweedfs_tpu_torch.storage.volume_backup\n"
        "import seaweedfs_tpu_torch.server.ui\n"
        "import seaweedfs_tpu_torch.telemetry.trajectory\n"
        "import seaweedfs_tpu_torch.util.reswitness\n"
        "import seaweedfs_tpu_torch.util.chunk_cache\n"
        "import seaweedfs_tpu_torch.command.cli\n"
        "import seaweedfs_tpu_torch.query\n"
        "import seaweedfs_tpu_torch.filer\n"
        "import seaweedfs_tpu_torch.filer.filechunk_manifest\n"
        "import seaweedfs_tpu_torch.filer.sharding\n"
        "import seaweedfs_tpu_torch.filer.sharding.bench\n"
        "import seaweedfs_tpu_torch.telemetry.reporter\n"
        "import seaweedfs_tpu_torch.server.filer\n"
        "import seaweedfs_tpu_torch.shell.command_fs\n"
        "import seaweedfs_tpu_torch.s3\n"
        "import seaweedfs_tpu_torch.shell.command_s3\n"
        "import seaweedfs_tpu_torch.replication\n"
        "import seaweedfs_tpu_torch.notification\n"
        "import seaweedfs_tpu_torch.messaging\n"
        "import seaweedfs_tpu_torch.mount\n"
        "import seaweedfs_tpu_torch.mount.fuse_ctypes\n"
        "import seaweedfs_tpu_torch.server.webdav\n"
        "import seaweedfs_tpu_torch.ftpd\n"
        "seaweedfs_tpu_torch.shell.commands.all_commands()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'seaweedfs_tpu', 'bench', 'tools')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_weed_version_loads_neither_jax_nor_cryptography():
    """``python -m seaweedfs_tpu_torch version`` in a fresh interpreter:
    the port's ``weed`` starts without JAX, the reference, or the
    ``cryptography`` package that only ``util/cipher.py`` needs."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['seaweedfs_tpu_torch', 'version']\n"
        "try:\n"
        "    runpy.run_module('seaweedfs_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'seaweedfs_tpu', 'cryptography')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("seaweedfs-tpu version "), proc.stdout


@pytest.mark.parametrize("argv", (["s3", "-h"], ["filer.sync", "-h"],
                                  ["filer.replicate", "-h"],
                                  ["webdav", "-h"], ["mount", "-h"],
                                  ["msgBroker", "-h"]),
                         ids=lambda a: a[0])
def test_gateway_subcommands_load_no_torch(argv):
    """``python -m seaweedfs_tpu_torch s3 -h`` (and the replication,
    WebDAV, mount and broker subcommands) in a fresh interpreter: the
    gateways, the filer sync, the mount and the broker are client-side
    tiers and start without ``torch``, as importing their modules
    does."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['seaweedfs_tpu_torch'] + {argv!r}\n"
        "try:\n"
        "    runpy.run_module('seaweedfs_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import seaweedfs_tpu_torch.s3, seaweedfs_tpu_torch.replication\n"
        "import seaweedfs_tpu_torch.server.webdav\n"
        "import seaweedfs_tpu_torch.mount, seaweedfs_tpu_torch.messaging\n"
        "import seaweedfs_tpu_torch.mount.fuse_ctypes\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'seaweedfs_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "usage:" in proc.stdout, proc.stdout
