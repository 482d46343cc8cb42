"""Device meshes of the port: positions on cards, shaped by named axes.

The counterpart of ``seaweedfs_tpu/parallel/mesh.py``. The reference's
mesh is a ``jax.sharding.Mesh`` of distinct chips; here a :class:`Mesh`
is an object array of ``torch.device`` *positions*. A position names the
device its tiles live on, and the sharded paths give each position a
CUDA stream of its own. Positions may repeat a device:
``devices=["cuda:0"] * 4`` is four positions on one card (the mesh code
paths at N > 1 on a machine with one card), and ``devices=["cpu"] * 8``
is the CPU tests' counterpart of the reference's 8 forced host devices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device


class Mesh:
    """``devices``: an object array of ``torch.device`` positions whose
    dimensions are the ``axis_names``. ``shape`` maps each axis to its
    size and ``size`` counts the positions.

    Equality and hashing are by value (the positions in order, the shape
    and the axis names), so a mesh made again with the same values finds
    the same entry of ``ec_sharded``'s dispatch cache."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D positions for axes {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self.size = int(arr.size)

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.devices.flat),
                self.devices.shape, self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"[{', '.join(str(d) for d in self.devices.flat)}])")


def make_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, ...] = ("vol", "seq"),
    shape: tuple[int, ...] | None = None,
    devices=None,
) -> Mesh:
    """A mesh over the first ``n_devices`` positions.

    ``devices`` None means the visible cards, ``cuda:0 … cuda:{count-1}``,
    and raises without one; a list names the positions and may repeat a
    device (``["cpu"] * 8``, ``["cuda:0"] * 4``). Default 2-D ("vol",
    "seq"): volumes data-parallel on the first axis, shard byte columns
    sequence-parallel on the second. With no explicit shape the count is
    factored as (n // s, s) with s the largest power of two ≤ sqrt(n)
    that divides n, as the reference does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; name the positions, e.g. "
                "make_mesh(devices=['cpu'] * 8)"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    devices = devices[:n]
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            s = 1
            while s * 2 <= math.isqrt(n) and n % (s * 2) == 0:
                s *= 2
            shape = (n // s, s) + (1,) * (len(axis_names) - 2)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)
