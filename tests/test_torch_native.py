"""The port's native host codec against its plain versions and the
reference's binding, byte for byte: ``gf_matmul`` on RS(10,4) parity and
reconstruction matrices, ``crc32c`` chained and not; a build that cannot
run its compiler raises."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu import native as ref_native  # noqa: E402
from seaweedfs_tpu.storage import needle as ref_needle  # noqa: E402
from seaweedfs_tpu_torch import native  # noqa: E402
from seaweedfs_tpu_torch.ops import gf256  # noqa: E402
from seaweedfs_tpu_torch.storage import needle  # noqa: E402

RNG = np.random.default_rng(9)


def _matrices():
    present = [i for i in range(14) if i not in (0, 5, 11, 13)]
    rebuild, _ = gf256.reconstruction_matrix(10, 4, present)
    one, missing = gf256.reconstruction_matrix(10, 4, list(range(1, 11)))
    return {
        "parity": gf256.parity_matrix(10, 4),
        "rebuild {0,5,11,13}": rebuild,
        "one of ten": one[[missing.index(0)]],
    }


@pytest.mark.parametrize("name", list(_matrices()))
@pytest.mark.parametrize("n", [1, 31, 4096, 65_537])
def test_gf_matmul_matches_plain_and_reference(name, n):
    coeff = _matrices()[name]
    data = RNG.integers(0, 256, (coeff.shape[1], n), dtype=np.uint8)
    got = native.gf_matmul(coeff, data)
    assert got.dtype == np.uint8 and got.shape == (coeff.shape[0], n)
    np.testing.assert_array_equal(got, gf256.gf_matmul_cpu(coeff, data))
    np.testing.assert_array_equal(got, ref_native.gf_matmul(coeff, data))


def test_gf_matmul_takes_strided_rows_and_checks_shapes():
    coeff = gf256.parity_matrix(10, 4)
    slab = RNG.integers(0, 256, (10, 4096), dtype=np.uint8)
    view = slab[:, 7:1900]
    np.testing.assert_array_equal(native.gf_matmul(coeff, view),
                                  gf256.gf_matmul_cpu(coeff, view))
    with pytest.raises(ValueError):
        native.gf_matmul(coeff, slab[:9])


@pytest.mark.parametrize("n", [0, 1, 7, 8, 4096, 100_003])
def test_crc32c_matches_plain_and_reference(n):
    data = RNG.integers(0, 256, n, dtype=np.uint8).tobytes()
    want = needle._crc32c_soft(data)
    assert native.crc32c(data) == want
    assert ref_needle.crc32c(data) == want
    assert needle.crc32c(data) == want
    # the same bytes as an array, a bytearray and a memoryview
    assert native.crc32c(np.frombuffer(data, np.uint8)) == want
    assert native.crc32c(bytearray(data)) == want
    assert native.crc32c(memoryview(data)) == want


def test_crc32c_chains_like_the_reference():
    a = RNG.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    b = RNG.integers(0, 256, 777, dtype=np.uint8).tobytes()
    whole = needle._crc32c_soft(a + b)
    assert native.crc32c(b, native.crc32c(a)) == whole
    assert needle._crc32c_soft(b, needle._crc32c_soft(a)) == whole
    assert ref_needle.crc32c(b, ref_needle.crc32c(a)) == whole
    assert native.crc32c(b"123456789") == 0xE3069283  # the check value


def test_build_is_keyed_and_reused(tmp_path):
    first = native.compile_library(str(tmp_path))
    assert first.startswith(str(tmp_path)) and first.endswith(".so")
    assert native.compile_library(str(tmp_path)) == first
    assert [p.name for p in tmp_path.iterdir()] == [
        first.rsplit("/", 1)[1]
    ]  # no temporary file left behind


def test_a_build_that_cannot_run_its_compiler_raises(tmp_path, monkeypatch):
    with pytest.raises(native.NativeUnavailable):
        native.compile_library(str(tmp_path), cxx="no-such-compiler-g++")
    # through the public entry points too: no fallback to numpy
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "fresh"))
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(native.NativeUnavailable):
        native.gf_matmul(gf256.parity_matrix(10, 4),
                         np.zeros((10, 16), np.uint8))
    with pytest.raises(native.NativeUnavailable):
        needle.crc32c(b"abc")


def test_a_failing_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "gf256.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(native.NativeUnavailable, match="cannot build"):
        native.compile_library(str(tmp_path / "out"))
    assert not any((tmp_path / "out").iterdir())
