"""Cluster model: topology tree, volume layouts, placement, growth.

Behavioral model: weed/topology/ (node.go, topology.go, volume_layout.go,
volume_growth.go). The tree is Topology → DataCenter → Rack → DataNode;
placement honors "xyz" replica placement with weighted random picks.

The port's copy of ``seaweedfs_tpu/topology``.
"""

from .node import DataCenter, DataNode, Node, Rack  # noqa: F401
from .topology import Topology  # noqa: F401
from .volume_growth import VolumeGrowth, VolumeGrowOption  # noqa: F401
from .volume_layout import VolumeLayout  # noqa: F401
