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
                   ("shell", "command_ec.py")):
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
