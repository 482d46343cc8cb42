"""Filer store drivers: in-memory, SQLite, and an embedded
log-structured store.

The reference ships 11+ drivers behind one SPI (leveldb, mysql, postgres,
cassandra, redis, mongo, etcd, elastic, hbase — weed/filer/<driver>/).
This build ships the three that make sense without external services:

* MemoryStore — dict-backed, the test/demo store (leveldb-in-memory analog)
* SqliteStore — stdlib sqlite3, the durable single-node store; plays the
  role of the reference's abstract_sql drivers, including per-bucket
  table partitioning: paths under /buckets/<b>/ live in their own table
  and bucket delete DROPs it (weed/filer/abstract_sql/
  abstract_sql_store.go getTxOrDB + SupportBucketTable)
* LogStructuredStore — WAL segments + in-memory index with undo-log
  transactions and snapshot compaction; the embedded stand-in for the
  reference's LSM/KV driver class (leveldb/rocksdb/redis)

The port's copy of ``seaweedfs_tpu/filer/stores.py``.
"""

from __future__ import annotations

import json
import os
import re
import sqlite3
import threading
from bisect import bisect_left, bisect_right

from .entry import Entry
from .filerstore import register_store

BUCKETS_PREFIX = "/buckets/"
_BUCKET_NAME_RE = re.compile(r"[A-Za-z0-9._-]{1,100}")


@register_store("memory")
class MemoryStore:
    name = "memory"

    def __init__(self):
        self._entries: dict[str, str] = {}
        self._sorted_paths: list[str] = []
        self._kv: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            path = entry.full_path
            if path not in self._entries:
                i = bisect_left(self._sorted_paths, path)
                self._sorted_paths.insert(i, path)
            self._entries[path] = json.dumps(entry.to_dict())

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        raw = self._entries.get(path)
        return Entry.from_dict(json.loads(raw)) if raw else None

    def delete_entry(self, path: str) -> None:
        with self._lock:
            if path in self._entries:
                del self._entries[path]
                i = bisect_left(self._sorted_paths, path)
                if (
                    i < len(self._sorted_paths)
                    and self._sorted_paths[i] == path
                ):
                    del self._sorted_paths[i]

    def delete_folder_children(self, path: str) -> None:
        prefix = path.rstrip("/") + "/"
        with self._lock:
            # scan forward from the prefix instead of a U+FFFF upper
            # bound — names starting with non-BMP characters (legal in
            # object keys) sort above it and would survive
            lo = bisect_left(self._sorted_paths, prefix)
            hi = lo
            while hi < len(self._sorted_paths) and self._sorted_paths[
                hi
            ].startswith(prefix):
                hi += 1
            for p in self._sorted_paths[lo:hi]:
                del self._entries[p]
            del self._sorted_paths[lo:hi]

    def list_directory_entries(
        self,
        dir_path: str,
        start_file: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        base = dir_path.rstrip("/") or ""
        out = []
        with self._lock:
            lo = bisect_left(self._sorted_paths, base + "/")
            for p in self._sorted_paths[lo:]:
                if not p.startswith(base + "/"):
                    break
                name = p[len(base) + 1 :]
                if not name or "/" in name:
                    continue  # the dir itself, or deeper than one level
                if prefix and not name.startswith(prefix):
                    continue
                if start_file:
                    if inclusive and name < start_file:
                        continue
                    if not inclusive and name <= start_file:
                        continue
                out.append(
                    Entry.from_dict(json.loads(self._entries[p]))
                )
                if len(out) >= limit:
                    break
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._kv[bytes(key)] = bytes(value)

    def kv_get(self, key: bytes) -> bytes | None:
        return self._kv.get(bytes(key))

    def kv_delete(self, key: bytes) -> None:
        self._kv.pop(bytes(key), None)

    def begin_transaction(self) -> None:
        pass

    def commit_transaction(self) -> None:
        pass

    def rollback_transaction(self) -> None:
        pass

    def close(self) -> None:
        pass


@register_store("sqlite")
class SqliteStore:
    name = "sqlite"

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        # WAL lets readers proceed under a writer and survives far
        # more write concurrency than the rollback journal; the busy
        # timeout makes a briefly-locked database WAIT instead of
        # failing the op — under concurrent persona load the
        # alternative is spurious `database is locked`
        # OperationalErrors surfacing as 503s (weed/filer/sqlite uses
        # the same pair). Both are no-ops for :memory: databases.
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA busy_timeout=5000")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._lock = threading.RLock()
        # store-level transaction depth (abstract_sql BeginTransaction:
        # mutations inside a txn batch into ONE commit, and rollback
        # undoes the whole batch — the filer wraps rename in this)
        self._txn_depth = 0
        self._bucket_tables: set[str] = set()
        with self._lock:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS filemeta ("
                " dirname TEXT NOT NULL,"
                " name TEXT NOT NULL,"
                " meta TEXT NOT NULL,"
                " PRIMARY KEY (dirname, name))"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS filer_kv ("
                " k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            for (tn,) in self._db.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "AND name LIKE 'bucket=%'"
            ).fetchall():
                self._bucket_tables.add(tn[len("bucket="):])
            self._migrate_bucket_rows()
            self._db.commit()

    def _migrate_bucket_rows(self) -> None:
        """One-time upgrade: rows under /buckets/<b>/ written by the
        pre-partitioning store live in filemeta — move them into their
        bucket tables so existing objects stay visible."""
        rows = self._db.execute(
            "SELECT dirname, name, meta FROM filemeta WHERE "
            "dirname LIKE '/buckets/%'"
        ).fetchall()
        for d, n, meta in rows:
            b = self._bucket_of(f"{d}/{n}")
            if b is None:
                continue
            tn = self._table(b, create=True)
            self._db.execute(
                f'INSERT OR REPLACE INTO "{tn}" VALUES (?,?,?)',
                (d, n, meta),
            )
            self._db.execute(
                "DELETE FROM filemeta WHERE dirname=? AND name=?",
                (d, n),
            )

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        path = path.rstrip("/") or "/"
        if path == "/":
            return "", "/"
        d, _, n = path.rpartition("/")
        return d or "/", n

    # -- bucket partitioning (abstract_sql SupportBucketTable) -----------

    @staticmethod
    def _bucket_of(path: str) -> str | None:
        """Bucket name iff `path` is strictly INSIDE /buckets/<b>/ —
        the bucket directory entry itself stays in the default table."""
        if not path.startswith(BUCKETS_PREFIX):
            return None
        rest = path[len(BUCKETS_PREFIX):]
        b, sep, tail = rest.partition("/")
        if sep and tail and _BUCKET_NAME_RE.fullmatch(b):
            return b
        return None

    def _table(
        self, bucket: str | None, create: bool = False
    ) -> str | None:
        """Table for a bucket. Reads never CREATE (a lookup of a
        nonexistent bucket must not grow the schema): a missing table
        reads as None = no rows."""
        if bucket is None:
            return "filemeta"
        tn = f"bucket={bucket}"
        if bucket not in self._bucket_tables:
            if not create:
                return None
            self._db.execute(
                f'CREATE TABLE IF NOT EXISTS "{tn}" ('
                " dirname TEXT NOT NULL,"
                " name TEXT NOT NULL,"
                " meta TEXT NOT NULL,"
                " PRIMARY KEY (dirname, name))"
            )
            self._bucket_tables.add(bucket)
        return tn

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        with self._lock:
            tn = self._table(
                self._bucket_of(entry.full_path), create=True
            )
            self._db.execute(
                f'INSERT OR REPLACE INTO "{tn}" VALUES (?,?,?)',
                (d, n, json.dumps(entry.to_dict())),
            )
            self._maybe_commit()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = self._split(path)
        with self._lock:
            tn = self._table(self._bucket_of(path))
            if tn is None:
                return None
            row = self._db.execute(
                f'SELECT meta FROM "{tn}" WHERE dirname=? AND name=?',
                (d, n),
            ).fetchone()
        return Entry.from_dict(json.loads(row[0])) if row else None

    def delete_entry(self, path: str) -> None:
        d, n = self._split(path)
        with self._lock:
            tn = self._table(self._bucket_of(path))
            if tn is None:
                return
            self._db.execute(
                f'DELETE FROM "{tn}" WHERE dirname=? AND name=?',
                (d, n),
            )
            self._maybe_commit()

    def delete_folder_children(self, path: str) -> None:
        base = path.rstrip("/")
        with self._lock:
            if base in ("", "/", "/buckets"):
                # wiping an ancestor of every bucket: drop them all
                for b2 in list(self._bucket_tables):
                    self._db.execute(
                        f'DROP TABLE IF EXISTS "bucket={b2}"'
                    )
                self._bucket_tables.clear()
            b = self._bucket_of(base + "/x")
            if b is not None and base == BUCKETS_PREFIX + b:
                # deleting a whole bucket DROPs its table — one DDL
                # statement, not N row deletes (abstract_sql
                # DeleteFolderChildren onDeleteBucket → DropTable)
                self._db.execute(f'DROP TABLE IF EXISTS "bucket={b}"')
                self._bucket_tables.discard(b)
                self._maybe_commit()
                return
            tn = self._table(b)
            if tn is None:
                return
            # escape LIKE metacharacters in the dirname prefix, same
            # as list_directory_entries: a literal %/_ in a directory
            # name (legal in object keys) must not wildcard onto
            # unrelated subtrees — deleting /a_b must leave /aXb/*
            esc = (
                base.replace("\\", "\\\\")
                .replace("%", "\\%")
                .replace("_", "\\_")
            )
            self._db.execute(
                f'DELETE FROM "{tn}" WHERE dirname=? OR '
                "dirname LIKE ? ESCAPE '\\'",
                (base or "/", esc + "/%"),
            )
            self._maybe_commit()

    def list_directory_entries(
        self,
        dir_path: str,
        start_file: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        cmp = ">=" if inclusive else ">"
        # escape LIKE metacharacters so a literal %/_ in the prefix
        # (valid in object keys) doesn't wildcard-match — the
        # prefix-list pushdown happens in SQL, not post-filtering
        esc = (
            prefix.replace("\\", "\\\\")
            .replace("%", "\\%")
            .replace("_", "\\_")
        )
        with self._lock:
            # children of dir_path live in the table that dir's
            # CHILDREN route to
            tn = self._table(self._bucket_of(d + "/x"))
            if tn is None:
                return []
            q = (
                f'SELECT meta FROM "{tn}" WHERE dirname=? AND name '
                f"LIKE ? ESCAPE '\\' AND name {cmp} ? "
                "ORDER BY name LIMIT ?"
            )
            rows = self._db.execute(
                q, (d, esc + "%", start_file, limit)
            ).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO filer_kv VALUES (?,?)",
                (bytes(key), bytes(value)),
            )
            self._db.commit()

    def kv_get(self, key: bytes) -> bytes | None:
        with self._lock:
            row = self._db.execute(
                "SELECT v FROM filer_kv WHERE k=?", (bytes(key),)
            ).fetchone()
        return row[0] if row else None

    def kv_delete(self, key: bytes) -> None:
        with self._lock:
            self._db.execute(
                "DELETE FROM filer_kv WHERE k=?", (bytes(key),)
            )
            self._db.commit()

    def buckets(self) -> list[str]:
        """Buckets currently backed by their own table."""
        with self._lock:
            return sorted(self._bucket_tables)

    def _maybe_commit(self) -> None:
        if self._txn_depth == 0:
            self._db.commit()

    def begin_transaction(self) -> None:
        # hold the lock for the whole txn: sqlite has one writer, and
        # interleaved writers inside an open txn would batch into the
        # wrong commit
        self._lock.acquire()
        self._txn_depth += 1

    def commit_transaction(self) -> None:
        try:
            self._txn_depth -= 1
            if self._txn_depth == 0:
                self._db.commit()
        finally:
            self._lock.release()

    def rollback_transaction(self) -> None:
        try:
            self._txn_depth -= 1
            if self._txn_depth == 0:
                self._db.rollback()
                # DDL (bucket-table CREATE/DROP) inside the txn rolled
                # back too: resync the cache from the real schema so a
                # later write doesn't skip CREATE and hit 'no such
                # table'
                self._bucket_tables = {
                    tn[len("bucket="):]
                    for (tn,) in self._db.execute(
                        "SELECT name FROM sqlite_master WHERE "
                        "type='table' AND name LIKE 'bucket=%'"
                    ).fetchall()
                }
        finally:
            self._lock.release()

    def close(self) -> None:
        self._db.close()


@register_store("lsm")
class LogStructuredStore:
    """Embedded log-structured store: WAL segments + in-memory sorted
    index, undo-log transactions, snapshot compaction on rotation.

    The stand-in for the reference's LSM/KV driver class
    (weed/filer/leveldb, rocksdb, redis): every mutation appends one
    record to the active segment; restart replays segments in order;
    when the log grows past `compact_ratio`× the live set, a snapshot
    segment replaces the history.
    """

    name = "lsm"
    _REC = {"put", "del", "kvput", "kvdel"}

    def __init__(
        self,
        dir_path: str | None = None,
        segment_bytes: int = 4 << 20,
        compact_ratio: float = 4.0,
    ):
        import tempfile

        self._ephemeral = dir_path is None
        self._dir = dir_path or tempfile.mkdtemp(prefix="swtpu_lsm_")
        os.makedirs(self._dir, exist_ok=True)
        self._segment_bytes = segment_bytes
        self._compact_ratio = compact_ratio
        self._lock = threading.RLock()
        self._entries: dict[str, str] = {}
        self._sorted: list[str] = []
        self._kv: dict[bytes, bytes] = {}
        self._txn_depth = 0
        self._txn_wal: list[str] = []
        self._txn_undo: list[tuple] = []
        self._replay()
        self._seg_no = (
            max(self._segments(), default=-1) + 1
        )
        self._active = open(self._seg_path(self._seg_no), "ab")

    # -- segments --------------------------------------------------------

    def _seg_path(self, n: int) -> str:
        return os.path.join(self._dir, f"seg-{n:08d}.log")

    def _segments(self) -> list[int]:
        out = []
        for f in os.listdir(self._dir):
            if f.startswith("seg-") and f.endswith(".log"):
                out.append(int(f[4:-4]))
        return sorted(out)

    def _replay(self) -> None:
        for n in self._segments():
            with open(self._seg_path(n)) as f:
                lines = f.readlines()
            i = 0
            while i < len(lines):
                line = lines[i].strip()
                i += 1
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail write: stop this segment
                if rec.get("op") == "txn":
                    # transaction batch: apply ALL n records or none —
                    # a crash mid-commit must not replay half a rename
                    n_recs = int(rec["n"])
                    batch = []
                    ok = len(lines) - i >= n_recs
                    for j in range(i, i + n_recs if ok else i):
                        try:
                            batch.append(json.loads(lines[j]))
                        except json.JSONDecodeError:
                            ok = False
                            break
                    if not ok:
                        break  # torn batch: drop it and stop
                    for r in batch:
                        self._apply(r)
                    i += n_recs
                    continue
                self._apply(rec)

    def _apply(self, rec: dict) -> None:
        op = rec.get("op")
        if op == "put":
            self._mem_put(rec["p"], rec["m"])
        elif op == "del":
            self._mem_del(rec["p"])
        elif op == "kvput":
            import base64

            self._kv[base64.b64decode(rec["k"])] = base64.b64decode(
                rec["v"]
            )
        elif op == "kvdel":
            import base64

            self._kv.pop(base64.b64decode(rec["k"]), None)

    def _mem_put(self, path: str, meta: str) -> None:
        if path not in self._entries:
            i = bisect_left(self._sorted, path)
            self._sorted.insert(i, path)
        self._entries[path] = meta

    def _mem_del(self, path: str) -> None:
        if path in self._entries:
            del self._entries[path]
            i = bisect_left(self._sorted, path)
            if i < len(self._sorted) and self._sorted[i] == path:
                del self._sorted[i]

    def _append(self, rec: dict) -> None:
        """Caller holds the lock and has already applied to memory."""
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        if self._txn_depth:
            self._txn_wal.append(line)
            return
        self._active.write(line.encode())
        self._active.flush()
        if self._active.tell() >= self._segment_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._active.close()
        live = sum(len(m) for m in self._entries.values())
        logged = sum(
            os.path.getsize(self._seg_path(n))
            for n in self._segments()
        )
        if logged > self._compact_ratio * max(live, 1):
            self._compact()
        self._seg_no += 1
        self._active = open(self._seg_path(self._seg_no), "ab")

    def _compact(self) -> None:
        """Rewrite history as one snapshot segment (caller holds the
        lock with the active segment closed)."""
        import base64

        old = self._segments()
        self._seg_no += 1
        snap = self._seg_path(self._seg_no)
        with open(snap + ".tmp", "w") as f:
            for p in self._sorted:
                f.write(
                    json.dumps(
                        {"op": "put", "p": p, "m": self._entries[p]},
                        separators=(",", ":"),
                    )
                    + "\n"
                )
            for k, v in self._kv.items():
                f.write(
                    json.dumps(
                        {
                            "op": "kvput",
                            "k": base64.b64encode(k).decode(),
                            "v": base64.b64encode(v).decode(),
                        },
                        separators=(",", ":"),
                    )
                    + "\n"
                )
            f.flush()
            os.fsync(f.fileno())
        os.replace(snap + ".tmp", snap)
        for n in old:
            os.remove(self._seg_path(n))

    # -- SPI -------------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        path = entry.full_path
        meta = json.dumps(entry.to_dict())
        with self._lock:
            if self._txn_depth:
                self._txn_undo.append(
                    ("put", path, self._entries.get(path))
                )
            self._mem_put(path, meta)
            self._append({"op": "put", "p": path, "m": meta})

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        with self._lock:
            raw = self._entries.get(path)
        return Entry.from_dict(json.loads(raw)) if raw else None

    def delete_entry(self, path: str) -> None:
        with self._lock:
            if self._txn_depth:
                self._txn_undo.append(
                    ("put", path, self._entries.get(path))
                )
            self._mem_del(path)
            self._append({"op": "del", "p": path})

    def delete_folder_children(self, path: str) -> None:
        prefix = path.rstrip("/") + "/"
        with self._lock:
            # forward scan, not a U+FFFF bound (non-BMP names sort
            # above it)
            lo = bisect_left(self._sorted, prefix)
            hi = lo
            while hi < len(self._sorted) and self._sorted[
                hi
            ].startswith(prefix):
                hi += 1
            for p in list(self._sorted[lo:hi]):
                if self._txn_depth:
                    self._txn_undo.append(
                        ("put", p, self._entries.get(p))
                    )
                self._mem_del(p)
                self._append({"op": "del", "p": p})

    def list_directory_entries(
        self,
        dir_path: str,
        start_file: str = "",
        inclusive: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        base = dir_path.rstrip("/") or ""
        out: list[Entry] = []
        with self._lock:
            lo = bisect_left(self._sorted, base + "/")
            for p in self._sorted[lo:]:
                if not p.startswith(base + "/"):
                    break
                name = p[len(base) + 1 :]
                if not name or "/" in name:
                    continue
                if prefix and not name.startswith(prefix):
                    continue
                if start_file:
                    if inclusive and name < start_file:
                        continue
                    if not inclusive and name <= start_file:
                        continue
                out.append(
                    Entry.from_dict(json.loads(self._entries[p]))
                )
                if len(out) >= limit:
                    break
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        import base64

        key, value = bytes(key), bytes(value)
        with self._lock:
            if self._txn_depth:
                self._txn_undo.append(
                    ("kv", key, self._kv.get(key))
                )
            self._kv[key] = value
            self._append(
                {
                    "op": "kvput",
                    "k": base64.b64encode(key).decode(),
                    "v": base64.b64encode(value).decode(),
                }
            )

    def kv_get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._kv.get(bytes(key))

    def kv_delete(self, key: bytes) -> None:
        import base64

        key = bytes(key)
        with self._lock:
            if self._txn_depth:
                self._txn_undo.append(("kv", key, self._kv.get(key)))
            self._kv.pop(key, None)
            self._append(
                {"op": "kvdel", "k": base64.b64encode(key).decode()}
            )

    # -- transactions: read-your-writes + undo-log rollback --------------

    def begin_transaction(self) -> None:
        self._lock.acquire()
        self._txn_depth += 1

    def commit_transaction(self) -> None:
        try:
            self._txn_depth -= 1
            if self._txn_depth == 0:
                if self._txn_wal:
                    # ONE write: a txn header + every record — replay
                    # applies the batch only if complete, so a crash
                    # mid-commit can never persist half a rename
                    header = (
                        json.dumps(
                            {"op": "txn", "n": len(self._txn_wal)},
                            separators=(",", ":"),
                        )
                        + "\n"
                    )
                    self._active.write(
                        (header + "".join(self._txn_wal)).encode()
                    )
                    self._active.flush()
                self._txn_wal.clear()
                self._txn_undo.clear()
                if self._active.tell() >= self._segment_bytes:
                    self._rotate()
        finally:
            self._lock.release()

    def rollback_transaction(self) -> None:
        try:
            self._txn_depth -= 1
            if self._txn_depth == 0:
                for kind, key, old in reversed(self._txn_undo):
                    if kind == "put":
                        if old is None:
                            self._mem_del(key)
                        else:
                            self._mem_put(key, old)
                    else:
                        if old is None:
                            self._kv.pop(key, None)
                        else:
                            self._kv[key] = old
                self._txn_wal.clear()
                self._txn_undo.clear()
        finally:
            self._lock.release()

    def compact(self) -> None:
        with self._lock:
            self._active.close()
            self._compact()
            self._seg_no += 1
            self._active = open(self._seg_path(self._seg_no), "ab")

    def close(self) -> None:
        import shutil

        with self._lock:
            self._active.close()
        if self._ephemeral:
            shutil.rmtree(self._dir, ignore_errors=True)
