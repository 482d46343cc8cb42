"""The port's sweeps (``seaweedfs_tpu_torch/tools``) on the CPU at small
sizes: every row runs, keeps the reference's variants, and is byte-exact
against the plain version; rows are not timed off the card. And the
port's one timer, ``ops/timing``, refuses to time without a card.
"""

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu_torch.ops import timing  # noqa: E402
from seaweedfs_tpu_torch.tools import (  # noqa: E402
    Sweep,
    exp_batched,
    exp_dev8,
    exp_dev8b,
)

# rows each sweep keeps: the reference's variants, one row for each TPU
# tile sweep of a kernel that has no tile on the card
ROWS = {"exp_dev8": 8, "exp_dev8b": 11, "exp_batched": 5}


@pytest.mark.parametrize("mod,kw", [
    pytest.param(exp_dev8, {}, id="exp_dev8"),
    pytest.param(exp_dev8b, {}, id="exp_dev8b"),
    pytest.param(exp_batched, {"volumes": 8}, id="exp_batched"),
])
@pytest.mark.parametrize("shard_bytes", [1 << 16, 3 * 4096])
def test_sweep_rows_are_byte_exact(mod, kw, shard_bytes, capsys):
    rows = mod.main(device="cpu", shard_bytes=shard_bytes, **kw)
    name = mod.__name__.rsplit(".", 1)[1]
    assert len(rows) == ROWS[name]
    for row in rows:
        assert row["exact"], row["label"]
        assert row["ms"] is None and row["GBps"] is None
        assert row["in_bytes"] > 0
    out = capsys.readouterr().out
    assert "not timed" in out and "byte-exact=True" in out


def test_batched_sweep_with_ragged_volumes():
    rows = exp_batched.main(device="cpu", shard_bytes=4 * 3000, volumes=3)
    assert len(rows) == ROWS["exp_batched"]
    assert all(row["exact"] for row in rows)


def test_row_reports_a_difference():
    sw = Sweep("test", "cpu")
    x = sw.rand_bytes(2, 64)
    row = sw.row("differs", lambda: x ^ 1, x, x.numel())
    assert row["exact"] is False
    row = sw.row("shape", lambda: x[:, :32], x, x.numel())
    assert row["exact"] is False
    assert sw.row("same", lambda: x.clone(), x, x.numel())["exact"]


def test_rand_bytes_follow_the_seed():
    a = Sweep("a", "cpu", seed=7).rand_bytes(3, 100)
    b = Sweep("b", "cpu", seed=7).rand_bytes(3, 100)
    c = Sweep("c", "cpu", seed=8).rand_bytes(3, 100)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_sweeps_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        exp_dev8.main(shard_bytes=1 << 12)
    with pytest.raises(RuntimeError):
        timing.time_ms(lambda: None)


def test_sweep_defaults_are_the_references():
    """The reference's sizes: [10, 64 MiB] u8 for exp_dev8 and exp_dev8b;
    [10, 16 Mi] u32 words single and [8, 10, 2 Mi] batched for
    exp_batched."""
    import inspect

    for mod in (exp_dev8, exp_dev8b, exp_batched):
        params = inspect.signature(mod.main).parameters
        assert params["shard_bytes"].default == 64 << 20
        assert params["device"].default is None
    params = inspect.signature(exp_batched.main).parameters
    assert params["volumes"].default == 8
