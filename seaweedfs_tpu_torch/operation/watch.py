"""Client-side location watcher (wdclient KeepConnected analog).

Behavioral model: weed/wdclient/masterclient.go:16-180 — a background
stream consumes `VolumeLocation` deltas from the master into a vidMap
(vid → locations) so lookups are served from pushed state and a moved
volume is readable WITHOUT a failed request forcing a cache refresh.

`operation.lookup()` consults the registered watcher for a master before
falling back to the HTTP `/dir/lookup` poll.

The port's copy of ``seaweedfs_tpu/operation/watch.py``.
"""

from __future__ import annotations

import json
import threading
import time

from ..util import glog, http


class LocationWatcher:
    def __init__(self, master_url: str, reconnect_delay: float = 0.5):
        self.master_url = master_url
        self.reconnect_delay = reconnect_delay
        self._vid_locs: dict[int, dict[str, dict]] = {}
        self._epoch = ""  # broadcaster identity; changes on failover
        self._peers: list[str] = [master_url]
        self._lock = threading.Lock()
        self._running = True
        self._synced = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- queries ---------------------------------------------------------

    def lookup(self, vid: int) -> list[dict] | None:
        """Pushed locations for vid, or None when nothing is known (the
        caller falls back to a master poll)."""
        with self._lock:
            locs = self._vid_locs.get(vid)
            if not locs:
                return None
            return [dict(v) for v in locs.values()]

    def wait_synced(self, timeout: float = 5.0) -> bool:
        """True once at least one full location snapshot was applied."""
        return self._synced.wait(timeout)

    def stop(self) -> None:
        self._running = False

    # -- stream consumption ---------------------------------------------

    def _apply(self, ev: dict) -> None:
        # (EC shard deltas are in the wire protocol too but the client
        # map tracks normal vids only — EC lookups stay on the volume
        # server's tiered TTL cache, store_ec.go:223-264)
        typ = ev.get("type")
        url = ev.get("url", "")
        loc = {"url": url, "publicUrl": ev.get("public_url") or url}
        m = self._vid_locs
        with self._lock:
            if ev.get("reset"):
                m.clear()
                self._epoch = ev.get("epoch", "")
                if ev.get("peers"):
                    self._peers = list(ev["peers"])
                return
            if typ == "down":
                for vid in list(m):
                    m[vid].pop(url, None)
                    if not m[vid]:
                        del m[vid]
                return
            if typ == "full":
                have = set(ev.get("vids") or [])
                for vid in list(m):
                    if vid not in have:
                        m[vid].pop(url, None)
                        if not m[vid]:
                            del m[vid]
                for vid in have:
                    m.setdefault(vid, {})[url] = loc
                self._synced.set()
                return
            if typ == "delta":
                for vid in ev.get("new_vids") or []:
                    m.setdefault(vid, {})[url] = loc
                for vid in ev.get("deleted_vids") or []:
                    if vid in m:
                        m[vid].pop(url, None)
                        if not m[vid]:
                            del m[vid]

    def _resolve_leader(self) -> str:
        """Ask each known master for the leader; a dead master is
        skipped (masterclient.go:57-80 re-find-leader rotation)."""
        candidates = [self.master_url] + [
            p for p in self._peers if p != self.master_url
        ]
        for url in candidates:
            try:
                st = http.get_json(f"{url}/cluster/status", timeout=5)
                leader = st.get("Leader")
                if leader:
                    return leader
            except http.HttpError:
                continue
        return self.master_url

    def _run(self) -> None:
        seq = 0
        target = self.master_url
        while self._running:
            try:
                resp = http.request_stream(
                    "GET",
                    f"{target}/cluster/watch?since={seq}"
                    f"&epoch={self._epoch}",
                    timeout=30,
                )
                buf = b""
                with resp:
                    while self._running:
                        piece = resp.read(4096)
                        if not piece:
                            break
                        buf += piece
                        while b"\n" in buf:
                            line, buf = buf.split(b"\n", 1)
                            if not line.strip():
                                continue  # keepalive
                            ev = json.loads(line)
                            if ev.get("reset"):
                                seq = 0  # new epoch: fresh seq space
                            elif "seq" in ev:
                                seq = int(ev["seq"])
                            self._apply(ev)
            except http.HttpError as e:
                # not-leader redirect or connection loss: re-resolve
                try:
                    hint = json.loads(e.body or b"{}").get("leader")
                except ValueError:
                    hint = None
                target = hint or self._resolve_leader()
                glog.V(2).infof(
                    "location watch reconnect to %s: %s", target, e
                )
            except Exception as e:  # pragma: no cover - defensive
                glog.V(1).infof("location watch error: %s", e)
            if self._running:
                time.sleep(self.reconnect_delay)


_watchers: dict[str, LocationWatcher] = {}
_watcher_refs: dict[str, int] = {}
_watchers_lock = threading.Lock()


def start_location_watch(master_url: str) -> LocationWatcher:
    """Start (or share) the watcher for a master; refcounted so several
    components (filer, gateways, CLI) can ride one stream."""
    with _watchers_lock:
        w = _watchers.get(master_url)
        if w is None or not w._running:
            w = LocationWatcher(master_url)
            _watchers[master_url] = w
            _watcher_refs[master_url] = 0
        _watcher_refs[master_url] += 1
        return w


def get_watcher(master_url: str) -> LocationWatcher | None:
    return _watchers.get(master_url)


def stop_location_watch(master_url: str) -> None:
    with _watchers_lock:
        if master_url not in _watchers:
            return
        _watcher_refs[master_url] = _watcher_refs.get(master_url, 1) - 1
        if _watcher_refs[master_url] > 0:
            return
        w = _watchers.pop(master_url, None)
        _watcher_refs.pop(master_url, None)
    if w is not None:
        w.stop()
