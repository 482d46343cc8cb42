"""The port's autotuner: defaults without a card, keys carry the card's
name, its own cache file round-trips, and the reference's v5e cache
(.autotune_cache.json) is never read."""

import builtins
import json
import os

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu_torch.ops import autotune  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """An empty in-memory cache backed by a file under tmp_path."""
    path = tmp_path / "cache.json"
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(path))
    monkeypatch.setattr(autotune, "_mem", {})
    monkeypatch.setattr(autotune, "_times", {})
    monkeypatch.setattr(autotune, "_loaded", False)
    monkeypatch.setattr(autotune, "_device_name", lambda: "NVIDIA H100 test")
    return path


def test_defaults_per_kind():
    assert autotune.DEFAULTS["dev32"] == autotune.Choice("swar", 0)
    assert autotune.DEFAULTS["host"].method == "swar"
    assert autotune.DEFAULTS["dev8"].method in ("repack", "swar", "mxu")


def test_best_returns_default_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(autotune.AUTOTUNE_ENV, "1")

    def boom(*a, **kw):  # pragma: no cover - must not be reached
        raise AssertionError("nothing is measured without a card")

    monkeypatch.setattr(autotune, "measure", boom)
    for kind in ("dev32", "dev8", "host"):
        assert autotune.best(4, 10, kind=kind) == autotune.DEFAULTS[kind]


def test_best_does_not_measure_without_env(fresh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv(autotune.AUTOTUNE_ENV, raising=False)

    def boom(*a, **kw):  # pragma: no cover - must not be reached
        raise AssertionError("measure() must be gated behind the env var")

    monkeypatch.setattr(autotune, "measure", boom)
    assert autotune.best(4, 10, kind="dev8") == autotune.DEFAULTS["dev8"]


def test_best_measures_once_with_env(fresh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv(autotune.AUTOTUNE_ENV, "1")
    calls = []

    def fake(o, k, kind="dev8", shard_bytes=0):
        calls.append((o, k, kind))
        return autotune.Choice("mxu", 0)

    monkeypatch.setattr(autotune, "measure", fake)
    assert autotune.best(4, 10, kind="dev8") == autotune.Choice("mxu", 0)
    assert autotune.best(4, 10, kind="dev8") == autotune.Choice("mxu", 0)
    assert calls == [(4, 10, "dev8")]
    assert "NVIDIA H100 test:4x10:dev8" in json.loads(fresh.read_text())


def test_key_carries_the_device_name(monkeypatch):
    monkeypatch.setattr(autotune, "_device_name", lambda: "NVIDIA H100 80GB HBM3")
    key = autotune._key(4, 10, "dev8")
    assert key == "NVIDIA H100 80GB HBM3:4x10:dev8"
    monkeypatch.setattr(autotune, "_device_name", lambda: "NVIDIA H200")
    assert autotune._key(4, 10, "dev8") != key


def test_cache_roundtrip(fresh):
    autotune._load()
    key = autotune._key(4, 10, "dev8")
    with autotune._lock:
        autotune._mem[key] = autotune.Choice("repack", 65536)
        autotune._times[key] = {"repack/65536": 0.5, "swar/0": 0.7}
        autotune._save()
    raw = json.loads(fresh.read_text())
    assert raw == {key: {"method": "repack", "tile_n": 65536,
                         "candidates_ms": {"repack/65536": 0.5,
                                           "swar/0": 0.7}}}
    autotune._mem.clear()
    autotune._times.clear()
    autotune._loaded = False
    assert autotune.measured_times(4, 10, "dev8") == {"repack/65536": 0.5,
                                                      "swar/0": 0.7}
    assert autotune._mem[key] == autotune.Choice("repack", 65536)


def test_corrupt_cache_is_ignored(fresh):
    fresh.write_text("{not json")
    autotune._load()
    assert autotune._mem == {}


def test_reference_cache_is_never_read(monkeypatch):
    """Neither the default path nor a load opens .autotune_cache.json."""
    assert os.path.basename(autotune._CACHE_PATH) != ".autotune_cache.json"
    default = os.path.join(REPO, ".autotune_cache_torch.json")
    if autotune.CACHE_ENV not in os.environ:
        assert autotune._CACHE_PATH == default
    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(os.path.basename(str(path)))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    monkeypatch.setattr(autotune, "_loaded", False)
    monkeypatch.setattr(autotune, "_mem", {})
    monkeypatch.setattr(autotune, "_times", {})
    autotune._load()
    assert ".autotune_cache.json" not in opened


def test_cache_file_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        lines = [line.strip() for line in f]
    assert "/.autotune_cache_torch.json" in lines


def test_candidates_per_kind():
    dev8 = autotune.candidates("dev8")
    assert {c.method for c in dev8} == {"repack", "swar", "mxu"}
    assert [c.tile_n for c in dev8 if c.method == "repack"] == list(
        autotune.REPACK_TILES)
    assert autotune.candidates("dev32") == [autotune.Choice("swar", 0)]
    with pytest.raises(ValueError):
        autotune.candidates("host")


def test_measure_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        autotune.measure(4, 10, kind="dev8")
    assert autotune.measure(4, 10, kind="host") == autotune.DEFAULTS["host"]


def test_tune_shapes_releases_lock_during_measure(fresh, monkeypatch):
    def fake(o, k, kind="dev8", shard_bytes=0):
        assert not autotune._lock.locked(), "lock held during measure()"
        return autotune.Choice("swar", 0)

    monkeypatch.setattr(autotune, "measure", fake)
    got = autotune.tune_shapes([(4, 10)], kinds=("dev32", "dev8"))
    assert got[autotune._key(4, 10, "dev8")] == autotune.Choice("swar", 0)
    assert got[autotune._key(4, 10, "dev32")] == autotune.Choice("swar", 0)


@pytest.mark.parametrize("o,k", [(1, 10), (4, 10), (14, 10), (3, 6), (4, 20)])
def test_coeff_for_shape(o, k):
    assert autotune._coeff_for(o, k).shape == (o, k)
