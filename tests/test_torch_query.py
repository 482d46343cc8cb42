"""The port's JSON query (``query/``) and the volume server's
``/admin/query`` held against the reference's on the CPU: the same
documents through ``get_path``, ``apply_filter``, ``project`` and
``query_json_lines``, then one volume of seeded JSON needles queried on
a port ``VolumeServer(device="cpu")`` and a reference one, with the same
NDJSON."""

import http.client
import json
import random

import pytest

pytest.importorskip("torch")

from seaweedfs_tpu import query as ref_query  # noqa: E402
from seaweedfs_tpu.server.volume import (  # noqa: E402
    VolumeServer as RefVolumeServer,
)
from seaweedfs_tpu_torch import query as port_query  # noqa: E402
from seaweedfs_tpu_torch.server.volume import VolumeServer  # noqa: E402

NO_MASTER = "http://127.0.0.1:9"  # nothing listens: heartbeats fail
OPS = ("=", "eq", "!=", "ne", ">", "gt", ">=", "ge", "<", "lt", "<=", "le",
       "contains", "prefix", "bogus")
PATHS = ("id", "name", "tags.0", "tags.9", "meta.size", "meta.kind",
         "meta.nested.x", "missing", "tags.x", "name.first")


def _docs(seed, n):
    rng = random.Random(seed)
    kinds = ("log", "metric", "trace")
    out = []
    for i in range(n):
        doc = {"id": i, "name": rng.choice(("alpha", "beta", "alpine", "")),
               "tags": [rng.choice(kinds) for _ in range(rng.randint(0, 3))],
               "meta": {"size": rng.randint(0, 1000),
                        "kind": rng.choice(kinds + (None,))}}
        if rng.random() < 0.3:
            doc["meta"]["nested"] = {"x": rng.random()}
        out.append(doc)
    return out


def _outcome(fn, *args):
    try:
        r = fn(*args)
        return ("ok", list(r) if hasattr(r, "__next__") else r)
    except (ValueError, TypeError) as e:  # mixed types fail alike
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("path", PATHS)
def test_get_path_equal(path):
    docs = _docs(1, 40) + [[1, 2, 3], "text", None, 5]
    got = [port_query.get_path(d, path) for d in docs]
    assert got == [ref_query.get_path(d, path) for d in docs]


@pytest.mark.parametrize("op", OPS)
def test_filter_and_project_equal(op):
    docs = _docs(2, 60)
    values = (500, "al", "log", None, 0)
    for field in ("meta.size", "name", "meta.kind", "tags.0"):
        for value in values:
            flt = {"field": field, "op": op, "value": value}
            got = [_outcome(port_query.apply_filter, d, flt) for d in docs]
            want = [_outcome(ref_query.apply_filter, d, flt) for d in docs]
            assert got == want, flt
    for proj in (None, [], ["id"], ["name", "meta.size", "nope"]):
        assert [port_query.project(d, proj) for d in docs] == [
            ref_query.project(d, proj) for d in docs]


BLOBS = {
    "object": lambda docs: json.dumps(docs[0]).encode(),
    "array": lambda docs: json.dumps(docs).encode(),
    "ndjson": lambda docs: "\n".join(json.dumps(d) for d in docs).encode(),
    "ndjson_with_junk": lambda docs: ("\n".join(
        json.dumps(d) for d in docs) + "\nnot json\n\n{\"id\": -1}").encode(),
    "empty": lambda docs: b"  \n",
    "binary": lambda docs: bytes(range(256)),
}


@pytest.mark.parametrize("shape", sorted(BLOBS))
def test_query_json_lines_equal(shape):
    blob = BLOBS[shape](_docs(3, 30))
    for flt, proj in ((None, None), ({"field": "meta.size", "op": ">=",
                                      "value": 300}, ["id", "meta.kind"]),
                      ({"field": "name", "op": "prefix", "value": "al"},
                       None), ({"field": "id", "op": "nope"}, None)):
        got = _outcome(port_query.query_json_lines, blob, flt, proj)
        assert got == _outcome(ref_query.query_json_lines, blob, flt, proj)


def _call(url, method, path, body=None):
    host = url.split("//")[-1]
    conn = http.client.HTTPConnection(host, timeout=60)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def test_admin_query_matches_reference(tmp_path):
    docs = _docs(4, 120)
    servers = {
        "ref": RefVolumeServer(NO_MASTER, [str(tmp_path / "ref")],
                               pulse_seconds=60),
        "port": VolumeServer(NO_MASTER, [str(tmp_path / "port")],
                             device="cpu", pulse_seconds=60),
    }
    for vs in servers.values():
        vs.start()
    try:
        for vs in servers.values():
            assert _call(vs.url, "POST", "/admin/assign_volume",
                         b'{"volume": 4}')[0] == 200
            for i, d in enumerate(docs):
                # one document, an array or NDJSON lines a needle
                body = (json.dumps(d) if i % 3 == 0 else json.dumps(
                    [d, {"id": -i}]) if i % 3 == 1 else
                    json.dumps(d) + "\n" + json.dumps({"id": -i}))
                fid = f"/4,{i + 1:x}{0x1000 + i:08x}"
                assert _call(vs.url, "POST", fid, body.encode())[0] in (
                    200, 201)
            assert _call(vs.url, "DELETE", f"/4,{2:x}{0x1001:08x}")[0] in (
                200, 202)
        bodies = (
            {"volume": 4},
            {"volume": 4, "filter": {"field": "meta.size", "op": ">",
                                     "value": 400},
             "projections": ["id", "name", "meta.kind"]},
            {"volume": 4, "filter": {"field": "tags.0", "op": "=",
                                     "value": "log"}, "limit": 7},
            {"fid": f"4,{5:x}{0x1004:08x}"},
            {"volume": 99},
            {"fid": "99,0100000001"},
            {"volume": 4, "filter": {"field": "id", "op": "what"}},
            {},
        )
        for body in bodies:
            got = {which: _call(vs.url, "POST", "/admin/query",
                                json.dumps(body).encode())
                   for which, vs in servers.items()}
            port, ref = got["port"], got["ref"]
            assert port[:2] == ref[:2], body
            if port[0] == 200:
                assert port[2] == ref[2], body
        status, _, ndjson = got_all = _call(
            servers["port"].url, "POST", "/admin/query",
            json.dumps(bodies[1]).encode())
        lines = [json.loads(x) for x in ndjson.decode().splitlines() if x]
        want = [{"id": d["id"], "name": d["name"],
                 "meta.kind": d["meta"]["kind"]}
                for i, d in enumerate(docs)
                if i != 1 and d["meta"]["size"] > 400]
        assert status == 200 and lines == want, got_all[:2]
    finally:
        for vs in servers.values():
            vs.stop()
