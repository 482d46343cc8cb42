"""Scale plane: fleet-size in-process scenarios.

`spec` declares the topology (dcs × racks × servers), `harness` spawns
it cheaply, `churn` kills/revives it from a seed, `converge` decides
when the cluster has self-healed, and `round` ties it all into one
recorded, regression-gated SCALE_rNN.json scenario.

The port's copy of ``seaweedfs_tpu/scale``. Its two entry points,
:class:`ScaleHarness` and :func:`run_scale_round`, take ``device=``:
``None`` is the card (and raises without one), ``"cpu"`` the kernels'
plain versions. A spec with filer shards runs the port's shard tier.
"""

from .churn import KINDS, ChurnEngine, ChurnProfile
from .converge import check_view, wait_for_convergence
from .harness import ScaleHarness
from .round import run_scale_round, scale_policy
from .spec import TopologySpec

__all__ = [
    "ChurnEngine",
    "ChurnProfile",
    "KINDS",
    "ScaleHarness",
    "TopologySpec",
    "check_view",
    "run_scale_round",
    "scale_policy",
    "wait_for_convergence",
]
