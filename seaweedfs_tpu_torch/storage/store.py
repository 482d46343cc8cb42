"""DiskLocation (one data directory) and Store (all locations on a node).

Behavioral model: weed/storage/disk_location.go:37-180 (concurrent volume
loading, vid maps), weed/storage/store.go:32-336 (needle op routing,
heartbeat collection, EC mounts). Loading uses a thread pool like the
reference's goroutine pool.

The port's copy of ``seaweedfs_tpu/storage/store.py``. Two differences.
A store counts the heartbeat pulses it collects, and ``allocate_volume``
returns the count at its add (``server/volume.py``'s allocation waits
for those pulses, where the reference's sends a heartbeat of its own).
And a store resolves its device once, at construction (``device=None`` is
the card and raises without one; ``"cpu"`` the kernels' plain
versions), and every ``EcVolume`` it mounts gets a codec of its own on
that device with the store's ``device_min_bytes`` and ``link_aware`` —
where the reference builds each on its default device and pins routes
only through environment knobs.
"""

from __future__ import annotations

import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import resolve_device
from ..ops.codec import DEVICE_MIN_BYTES, RSCodec
from ..pb.messages import (
    EcShardInformationMessage,
    Heartbeat,
    VolumeInformationMessage,
)
from . import types as t
from .ec_volume import EcVolume, ShardBits
from .erasure_coding import constants as C
from .needle import Needle
from .volume import Volume, VolumeClosedError

_DAT_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.dat$")
_ECX_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ecx$")


class DiskLocation:
    def __init__(
        self,
        directory: str | os.PathLike,
        max_volume_count: int = 7,
        needle_map_kind: str = "memory",
        device: str | torch.device | None = None,
        device_min_bytes: int = DEVICE_MIN_BYTES,
        link_aware: bool = True,
    ):
        self.device = resolve_device(device)
        self.device_min_bytes = device_min_bytes
        self.link_aware = link_aware
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        self.needle_map_kind = needle_map_kind
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        self._lock = threading.RLock()
        self.load_existing_volumes()

    def load_existing_volumes(self, workers: int = 8) -> None:
        matches = []
        for name in os.listdir(self.directory):
            if m := _DAT_RE.match(name):
                matches.append(("dat", name, m))
            elif m := _ECX_RE.match(name):
                matches.append(("ecx", name, m))
        # fresh dirs (every server a scale harness spawns) skip the
        # pool entirely — 100 servers × N dirs of executor setup is
        # pure startup overhead when there is nothing to load
        if not matches:
            return

        def load_dat(name, m):
            vid = int(m.group("vid"))
            col = m.group("col") or ""
            vol = Volume(
                self.directory, col, vid,
                needle_map_kind=self.needle_map_kind,
            )
            with self._lock:
                self.volumes[vid] = vol

        def load_ecx(name, m):
            vid = int(m.group("vid"))
            col = m.group("col") or ""
            base = os.path.join(self.directory, name[: -len(".ecx")])
            ev = EcVolume(base, vid, col, rs=self.new_codec())
            if ev.shards:
                with self._lock:
                    self.ec_volumes[vid] = ev
            else:
                ev.close()

        loaders = {"dat": load_dat, "ecx": load_ecx}
        with ThreadPoolExecutor(
            max_workers=min(workers, len(matches))
        ) as pool:
            futs = [
                pool.submit(loaders[kind], name, m)
                for kind, name, m in matches
            ]
            for f in futs:
                f.result()

    def new_codec(self) -> RSCodec:
        """A fresh RS(10,4) codec on this location's device and routing
        options: one an ``EcVolume``, as the reference builds one."""
        return RSCodec(
            C.DATA_SHARDS, C.PARITY_SHARDS, self.device,
            device_min_bytes=self.device_min_bytes,
            link_aware=self.link_aware,
        )

    def base_file_name(self, collection: str, vid: int) -> str:
        name = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(self.directory, name)

    @property
    def volume_count(self) -> int:
        return len(self.volumes)

    def free_slots(self) -> int:
        return max(0, self.max_volume_count - len(self.volumes))


class Store:
    """All disk locations on one volume server."""

    def __init__(
        self,
        dirs: list[str | os.PathLike],
        max_volume_counts: list[int] | None = None,
        ip: str = "localhost",
        port: int = 8080,
        public_url: str = "",
        data_center: str = "",
        rack: str = "",
        needle_map_kind: str = "memory",
        device: str | torch.device | None = None,
        device_min_bytes: int = DEVICE_MIN_BYTES,
        link_aware: bool = True,
    ):
        self.device = resolve_device(device)
        self.device_min_bytes = device_min_bytes
        self.link_aware = link_aware
        counts = max_volume_counts or [7] * len(dirs)
        self.locations = [
            DiskLocation(
                d, c, needle_map_kind=needle_map_kind, device=self.device,
                device_min_bytes=device_min_bytes, link_aware=link_aware,
            )
            for d, c in zip(dirs, counts)
        ]
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.data_center = data_center
        self.rack = rack
        self._lock = threading.RLock()
        # deltas drained into the next heartbeat
        self.new_volumes: list[VolumeInformationMessage] = []
        self.deleted_volumes: list[VolumeInformationMessage] = []
        self.new_ec_shards: list[EcShardInformationMessage] = []
        self.deleted_ec_shards: list[EcShardInformationMessage] = []
        # heartbeat pulses collected so far (not status reads): a
        # volume server's allocation answers once the pulses collected
        # before its volume was added have reached the master
        self.pulses_collected = 0

    # -- volume lookup/admin --------------------------------------------

    def find_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            if vid in loc.volumes:
                return loc.volumes[vid]
        return None

    def find_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            if vid in loc.ec_volumes:
                return loc.ec_volumes[vid]
        return None

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def find_free_location(self) -> DiskLocation | None:
        best, most = None, 0
        for loc in self.locations:
            free = loc.free_slots()
            if free > most:
                most, best = free, loc
        return best

    def add_volume(
        self,
        vid: int,
        collection: str = "",
        replica_placement: str = "000",
        ttl: str = "",
        version: int = t.CURRENT_VERSION,
    ) -> Volume:
        with self._lock:
            if self.find_volume(vid):
                raise ValueError(f"volume {vid} already exists")
            loc = self.find_free_location()
            if loc is None:
                raise RuntimeError("no free volume slots")
            vol = Volume(
                loc.directory,
                collection,
                vid,
                replica_placement=t.ReplicaPlacement.parse(
                    replica_placement
                ),
                ttl=t.TTL.parse(ttl),
                version=version,
                needle_map_kind=loc.needle_map_kind,
            )
            loc.volumes[vid] = vol
            self.new_volumes.append(self._volume_message(vol))
            return vol

    def allocate_volume(
        self,
        vid: int,
        collection: str = "",
        replica_placement: str = "000",
        ttl: str = "",
    ) -> int:
        """``add_volume``, returning the count of pulses collected
        before the volume existed: those its allocation waits to see
        delivered, since each one's full volume list lacks it."""
        with self._lock:
            self.add_volume(vid, collection, replica_placement, ttl)
            return self.pulses_collected

    def mount_volume(self, vid: int, collection: str = "") -> None:
        """Load an on-disk volume into the store (VolumeMount rpc,
        volume_grpc_admin.go) — the inverse of unmount_volume; the
        next heartbeat announces it as a new volume."""
        with self._lock:
            if self.find_volume(vid) is not None:
                return
            for loc in self.locations:
                base = loc.base_file_name(collection, vid)
                if os.path.exists(base + ".dat"):
                    vol = Volume(
                        loc.directory, collection, vid,
                        needle_map_kind=loc.needle_map_kind,
                    )
                    loc.volumes[vid] = vol
                    self.new_volumes.append(
                        self._volume_message(vol)
                    )
                    return
            raise KeyError(f"volume {vid} not on disk")

    def unmount_volume(self, vid: int) -> None:
        """Close + forget a volume, KEEPING its files on disk
        (VolumeUnmount rpc) — volume.move uses this window to copy."""
        with self._lock:
            for loc in self.locations:
                if vid in loc.volumes:
                    vol = loc.volumes.pop(vid)
                    self.deleted_volumes.append(
                        self._volume_message(vol)
                    )
                    vol.close()
                    return
            raise KeyError(f"volume {vid} not mounted")

    def delete_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                if vid in loc.volumes:
                    vol = loc.volumes.pop(vid)
                    self.deleted_volumes.append(
                        self._volume_message(vol)
                    )
                    vol.destroy()
                    return
            raise KeyError(f"volume {vid} not found")

    def mark_volume_readonly(self, vid: int) -> None:
        vol = self.find_volume(vid)
        if vol is None:
            raise KeyError(f"volume {vid} not found")
        vol.readonly = True

    def mark_volume_writable(self, vid: int) -> None:
        vol = self.find_volume(vid)
        if vol is None:
            raise KeyError(f"volume {vid} not found")
        vol.readonly = False

    # -- needle ops ------------------------------------------------------

    def write_volume_needle(
        self, vid: int, n: Needle, fsync: bool = False
    ) -> tuple[int, int]:
        vol = self.find_volume(vid)
        if vol is None:
            raise KeyError(f"volume {vid} not found")
        return vol.write_needle(n, fsync=fsync)

    def read_volume_needle(
        self, vid: int, key: int, cookie: int | None = None
    ) -> Needle:
        """A needle of a local volume. A volume closed between the
        lookup and the read (a tier move swapped it, or it was unmounted)
        is looked up once more; if it is gone, the answer is the same
        ``KeyError`` as for a volume never mounted here."""
        for _ in range(2):
            vol = self.find_volume(vid)
            if vol is None:
                break
            try:
                return vol.read_needle(key, cookie)
            except VolumeClosedError:
                continue
        raise KeyError(f"volume {vid} not found")

    def delete_volume_needle(self, vid: int, key: int) -> int:
        vol = self.find_volume(vid)
        if vol is None:
            raise KeyError(f"volume {vid} not found")
        return vol.delete_needle(key)

    # -- EC shard admin (store_ec.go:24-120) -----------------------------

    def mount_ec_shards(
        self, vid: int, collection: str, shard_ids: list[int]
    ) -> None:
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is None:
                for loc in self.locations:
                    base = loc.base_file_name(collection, vid)
                    if os.path.exists(base + ".ecx"):
                        ev = EcVolume(
                            base, vid, collection, rs=loc.new_codec(),
                            shard_ids=[],
                        )
                        loc.ec_volumes[vid] = ev
                        break
            if ev is None:
                raise KeyError(f"no ecx for ec volume {vid}")
            bits = ShardBits()
            for sid in shard_ids:
                if sid in ev.shards or ev.add_shard(sid):
                    bits = bits.add(sid)
            self.new_ec_shards.append(
                EcShardInformationMessage(
                    id=vid, collection=collection, ec_index_bits=bits.bits
                )
            )

    def unmount_ec_shards(self, vid: int, shard_ids: list[int]) -> None:
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is None:
                return
            bits = ShardBits()
            for sid in shard_ids:
                if sid in ev.shards:
                    ev.delete_shard(sid)
                    bits = bits.add(sid)
            self.deleted_ec_shards.append(
                EcShardInformationMessage(
                    id=vid,
                    collection=ev.collection,
                    ec_index_bits=bits.bits,
                )
            )
            if not ev.shards:
                for loc in self.locations:
                    loc.ec_volumes.pop(vid, None)
                ev.close()

    # -- heartbeat (store.go:208-299) ------------------------------------

    def _volume_message(self, vol: Volume) -> VolumeInformationMessage:
        s = vol.stat()
        return VolumeInformationMessage(
            id=vol.id,
            size=s.size,
            collection=vol.collection,
            file_count=s.file_count,
            delete_count=s.deleted_count,
            deleted_byte_count=s.deleted_bytes,
            read_only=vol.readonly,
            replica_placement=vol.super_block.replica_placement.to_byte(),
            version=vol.version,
            ttl=vol.ttl.to_uint32(),
            compact_revision=vol.super_block.compaction_revision,
            modified_at_second=vol.modified_at_second,
        )

    def collect_heartbeat(self, pulse: bool = True) -> Heartbeat:
        """The heartbeat of this store's state, draining its deltas;
        ``pulse=False`` for a read that sends nothing (it is not
        counted in ``pulses_collected``)."""
        with self._lock:
            volumes, max_key = [], 0
            for loc in self.locations:
                for vol in list(loc.volumes.values()):
                    try:
                        volumes.append(self._volume_message(vol))
                    except VolumeClosedError:
                        # closed under this pulse (its swap or unmount
                        # is mid-way): left out of this one heartbeat,
                        # never reported at size 0
                        continue
                    max_key = max(max_key, vol.nm.metrics.maximum_key)
            ec_shards = []
            for loc in self.locations:
                for ev in loc.ec_volumes.values():
                    bits = ShardBits()
                    for sid in ev.shard_ids:
                        bits = bits.add(sid)
                    ec_shards.append(
                        EcShardInformationMessage(
                            id=ev.id,
                            collection=ev.collection,
                            ec_index_bits=bits.bits,
                        )
                    )
            hb = Heartbeat(
                ip=self.ip,
                port=self.port,
                public_url=self.public_url,
                max_volume_count=sum(
                    loc.max_volume_count for loc in self.locations
                ),
                max_file_key=max_key,
                data_center=self.data_center,
                rack=self.rack,
                volumes=volumes,
                new_volumes=self.new_volumes,
                deleted_volumes=self.deleted_volumes,
                ec_shards=ec_shards,
                new_ec_shards=self.new_ec_shards,
                deleted_ec_shards=self.deleted_ec_shards,
                has_no_volumes=not volumes,
                has_no_ec_shards=not ec_shards,
            )
            self.new_volumes = []
            self.deleted_volumes = []
            self.new_ec_shards = []
            self.deleted_ec_shards = []
            if pulse:
                self.pulses_collected += 1
            return hb

    def close(self) -> None:
        for loc in self.locations:
            for vol in loc.volumes.values():
                vol.close()
            for ev in loc.ec_volumes.values():
                ev.close()
