"""A filer write finishes or fails inside its client's budget.

The filer uploads each 8 MiB piece of a write through an assign and a
volume-server POST; the POST could wait 120 s a try, while the filer's
clients give up on a silent socket after 30 s. The port's filer gives
each piece a budget (``WRITE_BUDGET_SECONDS``); its first try runs
under three quarters of it, so a try stalled on one hop is cut off and
retried on a fresh assignment, or the write answers an error before the
client gives up.

Here the volume server's write stalls (a ``latency`` fault on its
replica send) past a short client budget: once, and the write completes
on a fresh assignment, reads back byte-exact and records each try's
hops in ``/debug/slow``; or every time, and the filer answers 500 inside
the budget and leaves no entry. And a connect to the filer that gets no
answer is tried again on a new socket inside the client's timeout.
"""

import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from seaweedfs_tpu_torch import fault  # noqa: E402
from seaweedfs_tpu_torch.operation import client as port_client  # noqa: E402
from seaweedfs_tpu_torch.server import filer as filer_mod  # noqa: E402
from seaweedfs_tpu_torch.server.harness import ClusterHarness  # noqa: E402
from seaweedfs_tpu_torch.telemetry import slow  # noqa: E402
from seaweedfs_tpu_torch.util import http  # noqa: E402
from seaweedfs_tpu_torch.util import retry as port_retry  # noqa: E402

torch.set_num_threads(2)

CLIENT_TIMEOUT = 6.0  # the writing client's socket timeout
BUDGET = 4.0  # the filer's budget for one piece
STALL = 8.0  # the volume server's stalled write


@pytest.fixture
def clean():
    fault.REGISTRY.clear()
    yield
    fault.REGISTRY.clear()
    port_retry.BREAKERS.reset()
    port_client._lookup_cache.clear()


@pytest.mark.parametrize("stalls", [1, None],
                         ids=["stalls-once", "stalls-always"])
def test_filer_write_inside_client_budget(tmp_path, clean, monkeypatch,
                                         stalls):
    data = np.random.default_rng(24).bytes(2 << 20)
    monkeypatch.setattr(filer_mod, "WRITE_BUDGET_SECONDS", BUDGET,
                        raising=False)
    with ClusterHarness(n_volume_servers=2, device="cpu", with_filer=True,
                        root=str(tmp_path)) as c:
        f = c.filer
        # a replicated volume first, so the stalled write is the upload
        http.request("POST", f"{f.url}/warm.bin?replication=010", b"w" * 99)
        fault.REGISTRY.inject("volume.replicate.send", kind="latency",
                              delay=STALL, count=stalls)
        t0 = time.perf_counter()
        if stalls == 1:
            http.request("POST", f"{f.url}/d/x.bin?replication=010", data,
                         timeout=CLIENT_TIMEOUT)
            assert time.perf_counter() - t0 < CLIENT_TIMEOUT
            assert http.request("GET", f"{f.url}/d/x.bin") == data
            [write] = [e for e in slow.LEDGER.entries()
                       if e["component"] == "filer" and e["op"] == "write"
                       and len(e.get("hops", ())) == 2]
            first, second = write["hops"]
            assert "timed out" in first["error"]
            assert first["upload_s"] is None
            assert second["upload_s"] is not None
            assert "error" not in second
        else:
            with pytest.raises(http.HttpError) as e:
                http.request("POST", f"{f.url}/d/x.bin?replication=010",
                             data, timeout=CLIENT_TIMEOUT)
            assert e.value.status == 500, e.value
            assert time.perf_counter() - t0 < CLIENT_TIMEOUT
            with pytest.raises(http.HttpError) as e:
                http.request("GET", f"{f.url}/d/x.bin")
            assert e.value.status == 404


def test_first_try_leaves_a_reserve_for_a_fresh_one(monkeypatch):
    """Under a 2 s budget the first try runs under 1.5 s; stalled to
    its end, it leaves the rest to a try on a fresh assignment, and the
    hops record both."""
    budgets = []

    def assign(master, **kw):
        return port_client.Assignment(fid="3,01637037d6", url="v",
                                      public_url="v", count=1)

    def upload(url, fid, data, **kw):
        budgets.append(port_retry.remaining())
        if len(budgets) == 1:
            time.sleep(budgets[0])  # stalled until its share is spent
            raise http.HttpError(0, b"timed out")
        return len(data)

    monkeypatch.setattr(port_client, "assign", assign)
    monkeypatch.setattr(port_client, "upload", upload)
    hops = []
    with port_retry.deadline_scope(2.0):
        assert port_client.upload_data("m", b"x" * 10, hops=hops) == \
            ("3,01637037d6", 10)
    first, second = budgets
    assert 1.45 < first <= 1.5
    assert 0.3 < second <= 0.5
    assert "timed out" in hops[0]["error"] and "error" not in hops[1]


def _stall_first_connect(monkeypatch, port: int, times: int):
    """The first ``times`` connects to ``port`` get no answer: each
    waits out its timeout and raises, as an unanswered SYN does."""
    real = http._create_connection
    left = [times]

    def connect(address, timeout=None, source_address=None):
        if address[1] == port and left[0] > 0:
            left[0] -= 1
            time.sleep(timeout)
            raise TimeoutError("timed out")
        return real(address, timeout, source_address)

    monkeypatch.setattr(http, "_create_connection", connect)
    monkeypatch.setattr(http, "CONNECT_TRY_SECONDS", 1.0)


@pytest.mark.parametrize("stalls", [1, 99], ids=["once", "always"])
def test_unanswered_connect_tries_a_new_socket(tmp_path, clean,
                                               monkeypatch, stalls):
    """A connect to the filer that gets no answer is abandoned after
    ``CONNECT_TRY_SECONDS`` and tried on a new socket: the write lands
    byte-exact; if no connect is ever answered, the client still gives
    up at its own timeout, not later."""
    data = np.random.default_rng(25).bytes(1 << 20)
    with ClusterHarness(n_volume_servers=1, device="cpu", with_filer=True,
                        root=str(tmp_path)) as c:
        f = c.filer
        _stall_first_connect(monkeypatch, int(f.url.rsplit(":", 1)[1]),
                             stalls)
        t0 = time.perf_counter()
        if stalls == 1:
            http.request("POST", f"{f.url}/c/x.bin", data, timeout=3.0)
            assert time.perf_counter() - t0 < 3.0
            monkeypatch.undo()
            assert http.request("GET", f"{f.url}/c/x.bin") == data
        else:
            with pytest.raises(http.HttpError) as e:
                http.request("POST", f"{f.url}/c/x.bin", data, timeout=3.0)
            took = time.perf_counter() - t0
            assert e.value.status == 0 and 2.9 < took < 3.5
