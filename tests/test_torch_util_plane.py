"""The port's ``util/reswitness.py``, ``util/chunk_cache.py`` and
``util/cipher.py`` held against the reference's on the CPU.

* ``reswitness``: ``find_leaks`` flags the same sites on the same census
  histories; the port's witness tracks what the port's package creates,
  and ``install``/``uninstall`` put back exactly the factories they
  displaced, so the reference's witness, which the suite installs
  first, stays in place.
* ``chunk_cache``: memory hits, size-tiered disk hits, LRU evictions and
  one upstream fetch for concurrent misses, as the reference counts them.
* ``cipher``: round trips and the wire format both ways (only where
  ``cryptography`` is installed).
"""

import builtins
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")

from seaweedfs_tpu.util import chunk_cache as ref_cc  # noqa: E402
from seaweedfs_tpu.util import reswitness as ref_rw  # noqa: E402
from seaweedfs_tpu_torch.util import chunk_cache as port_cc  # noqa: E402
from seaweedfs_tpu_torch.util import reswitness as port_rw  # noqa: E402

HISTORIES = {
    "monotonic": [{"files": {"a:1": n}} for n in (0, 1, 2, 3, 5, 6)],
    "dip": [{"files": {"a:1": n}} for n in (0, 2, 4, 3, 6, 8)],
    "singleton": [{"threads": {"b:2": n}} for n in (0, 1, 1, 1, 1)],
    "late_site": [{}, {}, {"executors": {"c:3": 1}},
                  {"executors": {"c:3": 3}}, {"executors": {"c:3": 5}},
                  {"executors": {"c:3": 6}}],
    "mixed": [{"files": {"a:1": i, "d:4": 2 * i},
               "threads": {"b:2": 1}} for i in range(5)],
    "short": [{"files": {"a:1": n}} for n in (0, 10)],
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
@pytest.mark.parametrize("limits", [{}, {"min_growth": 2, "min_steps": 1}])
def test_find_leaks_matches_reference(name, limits):
    history = HISTORIES[name]
    got = port_rw.find_leaks(history, **limits)
    assert got == ref_rw.find_leaks(history, **limits)
    if name == "monotonic" and not limits:
        assert [leak["site"] for leak in got] == ["a:1"]
    if name in ("dip", "singleton"):
        assert got == []


@pytest.fixture
def port_witness():
    """The port's witness installed over whatever is in place, and
    removed again; the module's witness is put back as it was."""
    saved = port_rw._WITNESS
    before = (builtins.open, threading.Thread.__init__,
              ThreadPoolExecutor.__init__)
    port_rw._WITNESS = None
    w = port_rw.install()
    try:
        yield w, before
    finally:
        port_rw.uninstall()
        port_rw._WITNESS = saved
        assert (builtins.open, threading.Thread.__init__,
                ThreadPoolExecutor.__init__) == before


def test_install_uninstall_restore_what_they_displaced(port_witness):
    w, before = port_witness
    assert w.installed and w.displaced == before
    assert port_rw.install() is w  # idempotent
    assert builtins.open is not before[0]
    port_rw.uninstall()
    assert (builtins.open, threading.Thread.__init__,
            ThreadPoolExecutor.__init__) == before
    assert not w.installed
    port_rw.uninstall()  # a no-op when not installed
    assert builtins.open is before[0]
    # the reference's witness, which the suite installs, is untouched
    ref = ref_rw.current()
    if ref is not None and ref.installed:
        assert builtins.open == ref._open


def test_port_witness_tracks_the_port_s_resources(port_witness, tmp_path):
    w, _ = port_witness
    from seaweedfs_tpu_torch.storage.volume import Volume

    v = Volume(str(tmp_path), "", 1)
    census = w.census()
    sites = [s for s in census["files"] if "storage" in s]
    assert sites and all(s.startswith(os.path.dirname(port_rw.__file__)
                                      .rsplit(os.sep, 1)[0]) for s in sites)
    v.close()
    assert not [s for s in w.census()["files"] if "storage" in s]
    w.note_boundary()
    assert w.leaks() == []


def _cache_run(mod, root):
    """Hits, misses and evictions of one package's cache, by tier."""
    reg = mod.REGISTRY.__class__()
    counter = reg.counter(mod.CACHE_REQUESTS.name, "t", ("result", "tier"))
    saved = mod.CACHE_REQUESTS
    mod.CACHE_REQUESTS = counter
    try:
        c = mod.TieredChunkCache(mem_limit=3000, disk_dir=str(root),
                                 disk_limits=(4000, 9 << 20, 9 << 20))
        out = []
        base = time.time() - 100
        for i in range(6):
            # distinct ages, so the disk LRU evicts in one order
            for tier in range(i):
                path = c._disk_path(0, f"3,{tier:x}")
                if os.path.exists(path):
                    os.utime(path, (base + tier, base + tier))
            c.put(f"3,{i:x}", bytes([i]) * 1000)
        out.append([c.get(f"3,{i:x}") == bytes([i]) * 1000
                    for i in range(6)])
        c.put("big", b"B" * (2 << 20))
        out.append(c.get("big") == b"B" * (2 << 20))
        out.append(sorted(len(os.listdir(root / f"tier{t}"))
                          for t in range(3)))
        c.clear()
        out.append([c.get(f"3,{i:x}") is not None for i in range(6)])
        out.append(sorted(counter.values().items()))
        # concurrent misses of one chunk: one upstream fetch
        fetches = []
        gate = threading.Event()

        def fetch():
            fetches.append(1)
            gate.wait(5)
            return b"fetched"

        with ThreadPoolExecutor(6) as pool:
            futures = [pool.submit(c.get_or_fetch, "hot", fetch)
                       for _ in range(6)]
            while not fetches:
                time.sleep(0.001)
            gate.set()
            results = [f.result() for f in futures]
        out.append((len(fetches), results))
        return out
    finally:
        mod.CACHE_REQUESTS = saved


def test_chunk_cache_matches_reference(tmp_path):
    got = {which: _cache_run(mod, tmp_path / which)
           for which, mod in (("ref", ref_cc), ("port", port_cc))}
    # (the flight's hit/miss split is left out: a reader that comes
    # after the fetch hits the cache instead of joining the flight)
    assert got["port"][:-1] == got["ref"][:-1]
    hits, big, tiers, after_clear, counts, (n_fetch, results) = got["port"]
    assert dict(counts)[("hit", "disk0")] == 8
    # three chunks in memory, four in disk tier 0: the two oldest gone
    assert hits == after_clear == [False, False, True, True, True, True]
    assert big and tiers == [0, 1, 4]
    assert n_fetch == 1 and results == [b"fetched"] * 6


def test_cipher_round_trips_both_ways():
    pytest.importorskip("cryptography")
    from seaweedfs_tpu.util import cipher as ref_cipher
    from seaweedfs_tpu_torch.util import cipher as port_cipher

    for data in (b"", b"x", os.urandom(70_000)):
        key = port_cipher.gen_cipher_key()
        assert len(key) == len(ref_cipher.gen_cipher_key()) == 32
        blob = port_cipher.encrypt(data, key)
        assert blob != data or not data
        assert ref_cipher.decrypt(blob, key) == data
        assert port_cipher.decrypt(ref_cipher.encrypt(data, key),
                                   key) == data
        with pytest.raises(Exception):
            port_cipher.decrypt(blob, port_cipher.gen_cipher_key())
