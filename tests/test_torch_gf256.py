"""The port's GF(2^8) tables and coding matrices equal the reference's.

``seaweedfs_tpu_torch.ops.gf256`` is the port's own copy of
``seaweedfs_tpu.ops.gf256``; every table and every matrix the codec
uses must be the same bytes, including the reconstruction matrix of
every 1- to 4-loss pattern of RS(10,4).
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from seaweedfs_tpu.ops import gf256 as ref  # noqa: E402
from seaweedfs_tpu_torch.ops import gf256 as port  # noqa: E402


def test_tables_equal():
    np.testing.assert_array_equal(port.GF_EXP, ref.GF_EXP)
    np.testing.assert_array_equal(port.GF_LOG, ref.GF_LOG)
    np.testing.assert_array_equal(port.mul_table(), ref.mul_table())
    for a, b in [(0, 7), (3, 3), (29, 200), (255, 255), (2, 128)]:
        assert port.gf_mul(a, b) == ref.gf_mul(a, b)
        assert port.gf_pow(a, b) == ref.gf_pow(a, b)
        if b:
            assert port.gf_div(a, b) == ref.gf_div(a, b)


@pytest.mark.parametrize(
    "k,m", [(2, 1), (3, 2), (6, 3), (10, 4), (12, 4), (20, 4)]
)
def test_rs_matrix_equal(k, m):
    np.testing.assert_array_equal(port.rs_matrix(k, m), ref.rs_matrix(k, m))
    np.testing.assert_array_equal(
        port.parity_matrix(k, m), ref.parity_matrix(k, m)
    )


@pytest.mark.parametrize("losses", [1, 2, 3, 4])
def test_reconstruction_matrix_every_pattern(losses):
    """Every loss pattern of this size, first-k-present rule included."""
    k, m = 10, 4
    for lost in itertools.combinations(range(k + m), losses):
        present = [i for i in range(k + m) if i not in lost]
        r_port, miss_port = port.reconstruction_matrix(k, m, present)
        r_ref, miss_ref = ref.reconstruction_matrix(k, m, present)
        assert miss_port == miss_ref == list(lost)
        np.testing.assert_array_equal(r_port, r_ref, err_msg=str(lost))


def test_reconstruction_needs_k_shards():
    with pytest.raises(ValueError):
        port.reconstruction_matrix(10, 4, list(range(9)))
    r, missing = port.reconstruction_matrix(10, 4, list(range(14)))
    assert missing == [] and r.shape == (0, 10)


def test_gf_matmul_cpu_equal():
    rng = np.random.default_rng(11)
    for k, m in [(10, 4), (6, 3)]:
        data = rng.integers(0, 256, size=(k, 777), dtype=np.uint8)
        np.testing.assert_array_equal(
            port.encode_cpu(data, m), ref.encode_cpu(data, m)
        )
