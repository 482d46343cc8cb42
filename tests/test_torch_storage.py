"""The port's host-only storage copies equal the reference's: striping
layout, ``.idx`` parsing/packing/folding, and the phase timer."""

import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from seaweedfs_tpu.storage import idx as ref_idx  # noqa: E402
from seaweedfs_tpu.storage.erasure_coding import (  # noqa: E402
    layout as ref_layout,
)
from seaweedfs_tpu_torch.storage import idx, types  # noqa: E402
from seaweedfs_tpu_torch.storage.erasure_coding import layout  # noqa: E402
from seaweedfs_tpu_torch.telemetry.phases import PhaseTimer  # noqa: E402

LARGE, SMALL = 10_000, 100


@pytest.mark.parametrize(
    "dat_size", [1, 999, 99_999, 100_000, 100_001, 123_457, 1_000_000]
)
def test_layout_matches_reference(dat_size):
    args = (LARGE, SMALL)
    assert layout.encode_row_plan(dat_size, *args) == (
        ref_layout.encode_row_plan(dat_size, *args)
    )
    assert layout.shard_file_size(dat_size, *args) == (
        ref_layout.shard_file_size(dat_size, *args)
    )
    rng = np.random.default_rng(dat_size)
    for off in rng.integers(0, dat_size, 20).tolist() + [0, dat_size - 1]:
        size = int(rng.integers(1, 3 * LARGE))
        assert layout.locate_offset(off, dat_size, *args) == (
            ref_layout.locate_offset(off, dat_size, *args)
        )
        ours = layout.locate_data(off, size, dat_size, *args)
        ref = ref_layout.locate_data(off, size, dat_size, *args)
        assert [vars(i) for i in ours] == [vars(i) for i in ref]
        assert [layout.to_shard_id_and_offset(i, *args) for i in ours] == [
            ref_layout.to_shard_id_and_offset(i, *args) for i in ref
        ]


def test_production_row_plan_of_a_1gib_volume():
    """The main path's geometry: 103 small-block rows, no large rows."""
    rows = layout.encode_row_plan(1 << 30)
    assert len(rows) == 103
    assert {bs for _, bs in rows} == {layout.SMALL_BLOCK_SIZE}
    assert rows == ref_layout.encode_row_plan(1 << 30)


def _idx_log(rng, n):
    keys = rng.integers(1, 1 << 40, n).astype(np.uint64)
    keys[n // 2:] = keys[: n - n // 2]  # overwrites
    entries = np.zeros(n, dtype=idx.ENTRY_DTYPE)
    entries["key"] = keys
    entries["offset"] = rng.integers(0, 1 << 28, n) * 8
    entries["size"] = rng.integers(-1, 1 << 20, n)
    return entries


def test_idx_matches_reference():
    assert types.OFFSET_SIZE in (4, 5)
    entries = _idx_log(np.random.default_rng(3), 500)
    raw = idx.pack_entries(entries)
    assert raw == ref_idx.pack_entries(entries)
    assert len(raw) == 500 * types.NEEDLE_MAP_ENTRY_SIZE
    parsed = idx.parse_entries(raw + b"\x00" * 3)  # a torn tail is dropped
    np.testing.assert_array_equal(parsed, ref_idx.parse_entries(raw))
    np.testing.assert_array_equal(
        idx.sort_by_key(parsed), ref_idx.sort_by_key(parsed)
    )
    folded = idx.fold_entries(parsed)
    np.testing.assert_array_equal(folded, ref_idx.fold_entries(parsed))
    assert (np.diff(folded["key"].astype(np.float64)) > 0).all()
    assert not ((folded["offset"] == 0) | (folded["size"] < 0)).any()
    assert len(idx.fold_entries(parsed[:0])) == 0
    with pytest.raises(ValueError):
        big = parsed[:1].copy()
        big["offset"] = types.MAX_POSSIBLE_VOLUME_SIZE
        idx.pack_entries(big)


def test_phase_timer_accumulates_across_threads():
    pt = PhaseTimer("ec.encode")

    def work():
        for _ in range(100):
            pt.add("read", 0.001, 10)
            with pt.phase("write", 5):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    pt.note("batch_bytes", 4096)
    s = pt.summary()
    assert s["op"] == "ec.encode" and s["wall_seconds"] > 0
    assert s["phases"]["read"]["count"] == 400
    assert s["phases"]["read"]["bytes"] == 4000
    assert s["phases"]["read"]["seconds"] == pytest.approx(0.4)
    assert s["phases"]["write"]["count"] == 400
    assert s["notes"] == {"batch_bytes": 4096}
