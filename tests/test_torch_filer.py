"""The port's filer (``filer/``) held against the reference's on the CPU.

Each case runs one sequence of operations through each package's own
classes, in a directory of its own, and compares what the two saw: the
chunk algebra on seeded random chunk lists; ``Filer`` over each store
(memory, sqlite, log-structured) — listings, ``Entry.to_dict()`` values,
KV, chunk GC and meta events; the sqlite store's bucket tables; the
log-structured store's replay, compaction and torn batches, and the meta
log's segment files, byte for byte. Event stamps come from one pinned
clock and hard-link ids from one pinned token source in both packages.
Entry times left to the wall clock (a directory the filer makes for a
parent) are the only field masked.
"""

import importlib
import itertools
import json
import os
import random
import sqlite3
import types

import pytest

pytest.importorskip("torch")

PACKAGES = ("seaweedfs_tpu", "seaweedfs_tpu_torch")
STORES = ("memory", "sqlite", "lsm")
T0 = 1_000.0  # pinned entry times sit far below the wall clock


def _mods(pkg):
    imp = importlib.import_module
    return types.SimpleNamespace(
        entry=imp(f"{pkg}.filer.entry"),
        chunks=imp(f"{pkg}.filer.filechunks"),
        stores=imp(f"{pkg}.filer.stores"),
        core=imp(f"{pkg}.filer.filer"),
        log=imp(f"{pkg}.filer.log_buffer"),
    )


@pytest.fixture
def run_both(tmp_path, monkeypatch):
    """``run_both(fn)``: ``fn(m, root)`` for each package, on a fresh
    pinned clock and token source each; returns ``(ref, port)``."""

    def pin(m):
        ns = itertools.count(1_700_000_000_000_000_000, 1000)
        clock = types.SimpleNamespace(
            time_ns=lambda: next(ns), monotonic=m.core.time.monotonic,
            time=lambda: 1_700_000_000.0)
        tokens = (f"{i:032x}" for i in itertools.count(1))
        monkeypatch.setattr(m.core, "time", clock)
        monkeypatch.setattr(m.core, "secrets", types.SimpleNamespace(
            token_hex=lambda n=16: next(tokens)))

    def go(fn):
        out = []
        for pkg in PACKAGES:
            m = _mods(pkg)
            pin(m)
            root = tmp_path / pkg
            root.mkdir()
            out.append(fn(m, str(root)))
        return out

    return go


def _mask(d):
    """An entry dict with wall-clock attr times masked."""
    if not isinstance(d, dict):
        return d
    d = json.loads(json.dumps(d))
    attr = d.get("attr") or {}
    for k in ("mtime", "crtime"):
        if k in attr and attr[k] > 1e6:
            attr[k] = "wall"
    return d


def _entry(m, path, chunks=(), **attr):
    """An entry on the pinned attr clock."""
    attr.setdefault("mtime", T0)
    attr.setdefault("crtime", T0)
    return m.entry.Entry(
        full_path=path, attr=m.entry.Attr(**attr),
        chunks=[m.entry.FileChunk(file_id=f, offset=o, size=s, mtime=t)
                for f, o, s, t in chunks])


def _store(m, kind, root, name="f"):
    if kind == "memory":
        return m.stores.MemoryStore()
    if kind == "sqlite":
        return m.stores.SqliteStore(os.path.join(root, name + ".db"))
    return m.stores.LogStructuredStore(os.path.join(root, name + ".lsm"))


def _outcome(fn, *args, **kw):
    try:
        r = fn(*args, **kw)
    except Exception as e:  # the exception's type is the observation
        return ("raise", type(e).__name__)
    if hasattr(r, "to_dict"):
        return _mask(r.to_dict())
    return r


def _tree(f, path="/"):
    """Every entry under ``path``, depth first, as masked dicts."""
    out = []
    for e in f.list_entries(path, limit=100000):
        out.append(_mask(e.to_dict()))
        if e.is_directory:
            out += _tree(f, e.full_path)
    return out


def _events(f):
    return [(e.ts_ns, e.directory, _mask(e.old_entry), _mask(e.new_entry),
             e.is_delete) for e in f.events_since(0)]


# -- chunk algebra --------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_chunk_algebra_equal(seed, run_both):
    def algebra(m, root):
        rng = random.Random(seed)
        out = []
        for _ in range(50):
            chunks = [m.entry.FileChunk(
                file_id=f"c{i}", offset=rng.randint(0, 500),
                size=rng.randint(1, 200), mtime=rng.randint(0, 6))
                for i in range(rng.randint(0, 12))]
            vis = m.chunks.non_overlapping_visible_intervals(chunks)
            off, size = rng.randint(0, 600), rng.randint(0, 400)
            out.append((
                [vars(v) for v in vis],
                [(vars(v), o, n) for v, o, n in
                 m.chunks.read_resolved_chunks(vis, off, size)],
                m.chunks.total_size(chunks),
                m.entry.Entry(full_path="/x", chunks=chunks).size))
        return out

    ref, port = run_both(algebra)
    assert port == ref
    assert any(len(v) > 2 for v, _, _, _ in port)


def test_entry_round_trip_equal(run_both):
    def round_trip(m, root):
        e = _entry(m, "/a/b.txt", [("1,ab", 0, 5, 3)], mode=0o120777,
                   symlink_target="/t", group_names=["g"], file_size=9)
        e.extended = {"Seaweed-X": "y"}
        e.hard_link_id, e.hard_link_counter = "ff", 2
        d = e.to_dict()
        back = m.entry.Entry.from_dict(json.loads(json.dumps(d)))
        return (d, back.to_dict(), e.name, e.parent, e.size,
                e.is_directory, m.entry.new_directory_entry("/d").is_directory,
                m.entry.FileChunk.from_dict({"file_id": "1,x", "offset": 0,
                                             "size": 1, "junk": 1}).to_dict())

    ref, port = run_both(round_trip)
    assert port == ref


# -- Filer over each store --------------------------------------------------


def _crud(m, f):
    obs = [_outcome(f.create_entry, _entry(m, "/a/b/c.txt"))]
    obs.append(_outcome(f.create_entry, _entry(m, "/a/b/a.txt")))
    obs.append([e.name for e in f.list_entries("/a/b")])
    obs.append([e.name for e in f.list_entries("/a/b", start_file="a.txt")])
    obs.append([e.name for e in f.list_entries("/a/b", start_file="a.txt",
                                               inclusive=True)])
    obs.append([e.name for e in f.list_entries("/a/b", prefix="c")])
    obs.append([e.name for e in f.list_entries("/a/b", limit=1)])
    obs.append(_outcome(f.find_entry, "/a/"))
    obs.append(_outcome(f.mkdir, "/m/n"))
    obs.append(_outcome(f.mkdir, "/m/n"))
    upd = _entry(m, "/a/b/a.txt", [("5,aa", 0, 3, 1)], mime="text/x")
    obs.append(_outcome(f.update_entry, upd))
    obs.append(_outcome(f.find_entry, "/a/b/a.txt"))
    return obs


def _delete_recursive(m, f):
    obs = [_outcome(f.create_entry, _entry(m, "/d/f1", [("1,abc", 0, 10, 1)]))]
    obs.append(_outcome(f.create_entry,
                        _entry(m, "/d/sub/f2", [("2,def", 0, 10, 1)])))
    obs.append(_outcome(f.delete_entry, "/d"))
    obs.append(_outcome(f.delete_entry, "/d", recursive=True))
    obs.append(_outcome(f.delete_entry, "/nope"))
    obs.append(_outcome(f.create_entry, _entry(m, "/k/f", [("3,a", 0, 1, 1)])))
    obs.append(_outcome(f.delete_entry, "/k/f", gc_chunks=False))
    return obs


def _rename(m, f):
    obs = [_outcome(f.create_entry, _entry(m, "/x/1.txt", [("1,a", 0, 4, 1)]))]
    obs.append(_outcome(f.create_entry, _entry(m, "/x/sub/2.txt")))
    obs.append(_outcome(f.create_entry,
                        _entry(m, "/y2/over", [("7,o", 0, 2, 1)])))
    obs.append(_outcome(f.rename, "/x", "/y"))
    obs.append(_outcome(f.rename, "/y/1.txt", "/y2/over"))
    obs.append(_outcome(f.rename, "/missing", "/z"))
    return obs


def _overwrite(m, f):
    obs = [_outcome(f.create_entry, _entry(m, "/f", [("1,a", 0, 5, 1)]))]
    obs.append(_outcome(f.create_entry, _entry(
        m, "/f", [("1,b", 0, 9, 2), ("1,c", 9, 1, 3)])))
    obs.append(_outcome(f.create_entry, _entry(m, "/f", [("1,c", 0, 1, 4)])))
    return obs


def _kv(m, f):
    s = f.store
    obs = [s.kv_put(b"k", b"v"), s.kv_get(b"k"), s.kv_get(b"none")]
    s.kv_put(b"k", b"v2")
    s.kv_put(b"\x00bin", bytes(range(256)))
    obs += [s.kv_get(b"k"), s.kv_get(b"\x00bin")]
    s.kv_delete(b"k")
    obs.append(s.kv_get(b"k"))
    return obs


def _hardlinks(m, f):
    obs = [_outcome(f.create_entry, _entry(m, "/h/a", [("1,a", 0, 5, 1)]))]
    obs.append(_outcome(f.link, "/h/a", "/h/b"))
    b = f.find_entry("/h/b")
    obs.append(_outcome(f.create_entry, _entry(
        m, "/h/b", [("1,b", 0, 9, 2)])))
    obs.append(_outcome(f.find_entry, "/h/a"))
    obs.append(_outcome(f.link, "/h/b", "/h/c"))
    obs.append(_outcome(f.rename, "/h/a", "/h/a2"))
    obs.append(_outcome(f.delete_entry, "/h/a2"))
    obs.append(_outcome(f.find_entry, "/h/b"))
    obs.append(_outcome(f.delete_entry, "/h/c"))
    obs.append(_outcome(f.delete_entry, "/h/b"))
    obs.append(_outcome(f.link, "/nope", "/h/x"))
    obs.append(_outcome(f.mkdir, "/dd"))
    obs.append(_outcome(f.link, "/dd", "/h/x"))
    f.create_entry(_entry(m, "/f1"))
    f.create_entry(_entry(m, "/f2"))
    obs.append(_outcome(f.link, "/f1", "/f2"))
    # one name inside a directory that is deleted whole: a decrement
    f.create_entry(_entry(m, "/keep/f", [("3,x", 0, 4, 1)]))
    obs.append(_outcome(f.link, "/keep/f", "/tmp/link"))
    obs.append(_outcome(f.delete_entry, "/tmp", recursive=True))
    obs.append(_outcome(f.find_entry, "/keep/f"))
    obs.append(b.hard_link_id)
    return obs


def _symlink_and_names(m, f):
    obs = [_outcome(f.create_entry, _entry(
        m, "/s/lnk", mode=0o120777, symlink_target="/s/target"))]
    obs.append(_outcome(f.find_entry, "/s/lnk"))
    obs.append(_outcome(f.create_entry, _entry(
        m, "/emo/\U0001F600.jpg", [("8,e", 0, 4, 1)])))
    obs.append(_outcome(f.create_entry, _entry(m, "/emo/plain.txt")))
    obs.append(_outcome(f.create_entry, _entry(m, "/emo/zé.txt")))
    obs.append([e.name for e in f.list_entries("/emo")])
    obs.append(_outcome(f.delete_entry, "/emo", recursive=True))
    return obs


def _buckets(m, f):
    obs = [_outcome(f.mkdir, "/buckets/photos")]
    for i in range(6):
        obs.append(_outcome(f.create_entry, _entry(
            m, f"/buckets/photos/o{i}", [(f"4,{i}", 0, 3, 1)])))
    obs.append(_outcome(f.create_entry, _entry(
        m, "/buckets/photos/sub/dog.jpg")))
    obs.append(_outcome(f.find_entry, "/buckets/typo/obj"))
    obs.append([e.name for e in f.list_entries("/buckets/typo")])
    obs.append(_outcome(f.delete_entry, "/buckets/typo/obj"))
    obs.append(_outcome(f.delete_entry, "/buckets/photos", recursive=True))
    obs.append([e.name for e in f.list_entries("/buckets")])
    obs.append(_outcome(f.create_entry, _entry(m, "/buckets/photos/fresh")))
    return obs


SCENARIOS = {
    "crud": _crud, "delete_recursive": _delete_recursive, "rename": _rename,
    "overwrite": _overwrite, "kv": _kv, "hardlinks": _hardlinks,
    "symlink_and_names": _symlink_and_names, "buckets": _buckets,
}


@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_filer_scenario_equal(scenario, kind, run_both):
    def drive(m, root):
        gc = []
        f = m.core.Filer(_store(m, kind, root),
                         delete_chunks_fn=lambda cs: gc.append(
                             [c.to_dict() for c in cs]))
        obs = SCENARIOS[scenario](m, f)
        got = (obs, _tree(f), gc, _events(f))
        f.close()
        return got

    ref, port = run_both(drive)
    assert port == ref
    assert port[3] or scenario == "kv", "no events"


@pytest.mark.parametrize("kind", STORES)
def test_hardlinked_delete_notice_equal(kind, run_both):
    """The delete notice of a hard-linked name: both packages send the
    resolved entry (its chunks), as ``link`` and ``_hl_update`` do."""

    def drive(m, root):
        f = m.core.Filer(_store(m, kind, root))
        f.create_entry(_entry(m, "/e/a", [("9,c", 0, 7, 1)]))
        f.link("/e/a", "/e/b")
        seen = []
        f.subscribe(lambda ev: seen.append(
            (ev.directory, _mask(ev.old_entry), _mask(ev.new_entry))))
        f.delete_entry("/e/a")
        f.delete_entry("/e/b")
        f.close()
        return seen

    ref, port = run_both(drive)
    assert port == ref
    assert [old["chunks"][0]["file_id"] for _, old, _ in port] == [
        "9,c", "9,c"]


@pytest.mark.parametrize("kind", ("sqlite", "lsm"))
def test_rename_rolls_back_equal(kind, run_both):
    def drive(m, root):
        f = m.core.Filer(_store(m, kind, root))
        f.mkdir("/src")
        f.create_entry(_entry(m, "/src/a.txt"))
        f.create_entry(_entry(m, "/src/b.txt"))
        real_delete = f.store.delete_entry

        def failing_delete(path):
            if path.endswith("b.txt"):
                raise RuntimeError("disk on fire")
            real_delete(path)

        f.store.delete_entry = failing_delete
        failed = _outcome(f.rename, "/src", "/dst")
        f.store.delete_entry = real_delete
        before = _tree(f)
        ok = _outcome(f.rename, "/src", "/dst")
        got = (failed, before, ok, _tree(f), _events(f))
        f.close()
        return got

    ref, port = run_both(drive)
    assert port == ref
    assert port[0] == ("raise", "RuntimeError")


# -- the sqlite store ------------------------------------------------------------


def _tables(db):
    con = sqlite3.connect(db)
    try:
        return sorted(r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table'"))
    finally:
        con.close()


def _rows(db):
    con = sqlite3.connect(db)
    try:
        return {t: sorted(con.execute(f'SELECT * FROM "{t}"').fetchall())
                for t in _tables(db)}
    finally:
        con.close()


def test_sqlite_bucket_tables_equal(run_both):
    def drive(m, root):
        db = os.path.join(root, "f.db")
        s = m.stores.SqliteStore(db)
        obs = []
        s.begin_transaction()
        s.insert_entry(_entry(m, "/x"))
        s.insert_entry(_entry(m, "/buckets/newb/obj"))
        s.rollback_transaction()
        obs.append(_tables(db))
        for p in ("/buckets/newb/obj2", "/buckets/keep/obj",
                  "/buckets/keep/sub/deep", "/plain.txt"):
            s.insert_entry(_entry(m, p))
        obs.append((s.buckets(), _rows(db)))
        s.delete_folder_children("/buckets/newb")
        obs.append((s.buckets(), _tables(db)))
        s.close()
        s = m.stores.SqliteStore(db)
        obs.append((s.buckets(), _outcome(s.find_entry,
                                          "/buckets/keep/sub/deep")))
        s.close()
        return obs

    ref, port = run_both(drive)
    assert port == ref


def test_sqlite_legacy_rows_migrate_equal(run_both):
    def drive(m, root):
        db = os.path.join(root, "f.db")
        raw = sqlite3.connect(db)
        raw.execute(
            "CREATE TABLE filemeta (dirname TEXT NOT NULL, name TEXT "
            "NOT NULL, meta TEXT NOT NULL, PRIMARY KEY (dirname, name))")
        raw.execute("CREATE TABLE filer_kv (k BLOB PRIMARY KEY, "
                    "v BLOB NOT NULL)")
        for d, n, p in (("/buckets", "old", "/buckets/old"),
                        ("/buckets/old", "cat.jpg", "/buckets/old/cat.jpg"),
                        ("/buckets/old/sub", "dog.jpg",
                         "/buckets/old/sub/dog.jpg"),
                        ("/", "plain.txt", "/plain.txt")):
            e = _entry(m, p, mode=0o40755 if n == "old" else 0o660)
            raw.execute("INSERT INTO filemeta VALUES (?,?,?)",
                        (d, n, json.dumps(e.to_dict())))
        raw.commit()
        raw.close()
        s = m.stores.SqliteStore(db)
        got = (_rows(db), s.buckets(),
               [e.full_path for e in s.list_directory_entries(
                   "/buckets/old")])
        s.close()
        return got

    ref, port = run_both(drive)
    assert port == ref
    assert port[1] == ["old"]


@pytest.mark.parametrize("kind", STORES)
def test_like_metacharacters_equal(kind, run_both):
    """Prefix listings and a folder wipe under names holding ``%`` and
    ``_``: deleting ``/a_b``'s children leaves ``/aXb``'s alone in both
    packages (the escaped ``LIKE``)."""

    def drive(m, root):
        s = _store(m, kind, root)
        for p in ("/d/a%b.txt", "/d/aXb.txt", "/d/a_c.txt", "/a_b/x",
                  "/a_b/y/z", "/aXb/keep", "/a%b/keep2"):
            s.insert_entry(_entry(m, p))
        obs = [[e.full_path for e in s.list_directory_entries(
            "/d", prefix=pre)] for pre in ("a%", "a_", "a", "")]
        s.delete_folder_children("/a_b")
        obs += [_outcome(s.find_entry, p) for p in
                ("/a_b/x", "/a_b/y/z", "/aXb/keep", "/a%b/keep2")]
        s.close()
        return obs

    ref, port = run_both(drive)
    assert port == ref
    assert port[:2] == [["/d/a%b.txt"], ["/d/a_c.txt"]]
    assert port[6] != ("raise", "KeyError") and port[6] is not None


# -- the log-structured store and the meta log ---------------------------------


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_lsm_replay_compaction_and_torn_batches_equal(run_both):
    def drive(m, root):
        d = os.path.join(root, "lsm")
        s = m.stores.LogStructuredStore(d)
        for i in range(50):
            s.insert_entry(_entry(m, f"/d/f{i:03d}"))
        for i in range(0, 50, 2):
            s.delete_entry(f"/d/f{i:03d}")
        s.kv_put(b"ck", b"cv")
        s.begin_transaction()
        s.insert_entry(_entry(m, "/t/full_a"))
        s.insert_entry(_entry(m, "/t/full_b"))
        s.commit_transaction()
        s.close()
        obs = [_files(d)]
        s = m.stores.LogStructuredStore(d)
        obs.append([e.name for e in s.list_directory_entries(
            "/d", limit=100)])
        s.compact()
        obs.append(_files(d))
        s.close()
        seg = sorted(n for n in os.listdir(d) if n.startswith("seg-")
                     and os.path.getsize(os.path.join(d, n)))[-1]
        with open(os.path.join(d, seg), "a") as f:
            f.write(json.dumps({"op": "txn", "n": 2}) + "\n" + json.dumps(
                {"op": "put", "p": "/t/half",
                 "m": json.dumps(_entry(m, "/t/half").to_dict())}) + "\n")
            f.write('{"op":"put","p":"/t/torn')
        s = m.stores.LogStructuredStore(d)
        obs += [_outcome(s.find_entry, p) for p in
                ("/t/full_a", "/t/half", "/t/torn", "/d/f001")]
        obs.append(s.kv_get(b"ck"))
        s.close()
        obs.append(_files(d))
        return obs

    ref, port = run_both(drive)
    assert port == ref
    assert port[4] is None and port[5] is None  # torn batch, torn tail


def test_meta_log_segments_equal(run_both):
    def drive(m, root):
        d = os.path.join(root, "log")
        b = m.log.MetaLogBuffer(d, mem_events=3, segment_bytes=200,
                                max_segments=3)
        for i in range(60):
            b.append(m.log.MetaEvent(
                ts_ns=i + 1, directory=f"/d{i % 3}", old_entry=None,
                new_entry=None if i % 5 == 0 else {"full_path": f"/p{i}"}))
        obs = [[e.ts_ns for e in b.since(t, limit=lim)]
               for t, lim in ((0, 100), (40, 100), (57, 2))]
        b.close()
        obs.append(_files(d))
        with open(os.path.join(d, sorted(os.listdir(d))[-1]), "ab") as f:
            f.write(b'{"ts_ns": 61, "directory"')
        b2 = m.log.MetaLogBuffer(d)
        obs.append([e.ts_ns for e in b2.since(0)])
        b2.close()
        return obs

    ref, port = run_both(drive)
    assert port == ref
    assert len(port[3]) > 1


def test_filer_event_log_dir_equal(run_both):
    """A filer with a durable event log: the same segment bytes, and a
    reopened filer replays the same events."""

    def drive(m, root):
        d = os.path.join(root, "meta")
        f = m.core.Filer(m.stores.MemoryStore(), event_log_dir=d)
        f.create_entry(_entry(m, "/e/f", [("1,a", 0, 3, 1)]))
        f.rename("/e/f", "/e/g")
        f.delete_entry("/e/g")
        waited = [e.ts_ns for e in f.wait_for_events(0, 0.01)]
        f.close()
        raw = _files(d)
        for name, body in raw.items():
            raw[name] = [_mask(json.loads(line)["new_entry"])
                         for line in body.splitlines()]
        f2 = m.core.Filer(m.stores.MemoryStore(), event_log_dir=d)
        got = (waited, raw, [e.ts_ns for e in f2.events_since(0)])
        f2.close()
        return got

    ref, port = run_both(drive)
    assert port == ref


def test_meta_log_memory_tail_equal(run_both):
    """With no directory the log is its bounded memory tail alone."""

    def drive(m, root):
        b = m.log.MetaLogBuffer(None, mem_events=4)
        for i in range(10):
            b.append(m.log.MetaEvent(ts_ns=i + 1, directory="/",
                                     old_entry=None, new_entry=None))
        got = [[e.ts_ns for e in b.since(t, limit=lim)]
               for t, lim in ((0, 100), (8, 100), (0, 2), (10, 100))]
        b.close()
        return got

    ref, port = run_both(drive)
    assert port == ref
    assert port[0] == [7, 8, 9, 10]
