"""One package's ``weed`` on a pinned clock and seeded draws.

``python tests/_torch_weed_child.py {ref|port} <weed arguments...>`` runs
that package's CLI ``main`` with every record stamp the volume server
writes (``append_at_ns``, ``last_modified``) on one fixed clock and the
master's assign cookies and write picks drawn from seeded generators of
their own. Two packages' servers given the same uploads in the same
order then write the same ``.dat`` bytes, so their EC shards can be
held to each other.
"""

import importlib
import random
import sys
import time
import types

PACKAGES = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
EPOCH = 1_700_000_000


def _pinned_time():
    clock = types.SimpleNamespace(**{
        name: getattr(time, name) for name in dir(time)
        if not name.startswith("_")})
    clock.time = lambda: float(EPOCH)
    clock.time_ns = lambda: EPOCH * 10**9
    return clock


def main(argv):
    pkg = PACKAGES[argv[0]]
    clock = _pinned_time()
    for mod in ("server.volume", "storage.volume"):
        importlib.import_module(f"{pkg}.{mod}").time = clock
    importlib.import_module(f"{pkg}.server.master").random = (
        random.Random(7))
    importlib.import_module(f"{pkg}.topology.volume_layout").random = (
        random.Random(11))
    cli = importlib.import_module(f"{pkg}.command.cli")
    return cli.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
