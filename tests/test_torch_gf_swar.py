"""The port's GF(2^8) kernel wrapper and its plain PyTorch version.

On the CPU the wrapper runs the plain version, which must agree byte
for byte with the reference's Pallas ``_swar_kernel`` (run in interpret
mode, as tests/test_pallas_kernel.py runs it) and with the numpy oracle
``gf256.gf_matmul_cpu``. The CUDA kernel itself is held against the
plain version by the tests marked to need a card, and by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu.ops.pallas import gf_kernel  # noqa: E402
from seaweedfs_tpu_torch.ops import gf256  # noqa: E402
from seaweedfs_tpu_torch.ops.kernels import gf_swar  # noqa: E402

SHAPES = [(10, 4), (6, 3), (12, 4), (20, 4)]
RAGGED = [1, 3, 1000, 5000]
# one Pallas tile (in u32 lanes) wide enough for every ragged N, so the
# interpret-mode reference compiles once per matrix
PALLAS_TILE4 = 2048


def rng_for(*params):
    import zlib

    return np.random.default_rng(zlib.crc32(repr(params).encode()))


def plain(coeff, data: np.ndarray) -> np.ndarray:
    return gf_swar.gf_matmul(coeff, torch.from_numpy(data)).numpy()


def pallas_swar(coeff, data: np.ndarray) -> np.ndarray:
    return np.asarray(
        gf_kernel.gf_matmul_pallas(
            coeff, data, method="swar", tile_n=PALLAS_TILE4
        )
    )


@pytest.mark.parametrize("k,m", SHAPES)
def test_parity_matches_pallas_and_oracle(k, m):
    coeff = ref_gf256.parity_matrix(k, m)
    for n in RAGGED:
        data = rng_for(k, m, n).integers(0, 256, (k, n), dtype=np.uint8)
        got = plain(coeff, data)
        assert got.shape == (m, n)
        np.testing.assert_array_equal(got, ref_gf256.gf_matmul_cpu(coeff, data))
        np.testing.assert_array_equal(got, pallas_swar(coeff, data))


def test_batched_matches_pallas():
    k, m, n, b = 10, 4, 384, 3
    coeff = ref_gf256.parity_matrix(k, m)
    data = rng_for("batched").integers(0, 256, (b, k, n), dtype=np.uint8)
    got = plain(coeff, data)
    assert got.shape == (b, m, n)
    np.testing.assert_array_equal(got, pallas_swar(coeff, data))
    for i in range(b):
        np.testing.assert_array_equal(
            got[i], ref_gf256.gf_matmul_cpu(coeff, data[i])
        )


@pytest.mark.parametrize("lost", [(3,), (0, 13), (1, 4, 12), (0, 5, 11, 13)])
def test_reconstruction_matrices(lost):
    k, m, n = 10, 4, 1000
    data = rng_for(lost).integers(0, 256, (k, n), dtype=np.uint8)
    shards = np.concatenate([data, ref_gf256.encode_cpu(data, m)])
    present = [i for i in range(k + m) if i not in lost]
    r, missing = ref_gf256.reconstruction_matrix(k, m, present)
    stack = shards[present[:k]]
    got = plain(r, stack)
    np.testing.assert_array_equal(got, shards[missing])
    if len(lost) in (1, 4):
        np.testing.assert_array_equal(got, pallas_swar(r, stack))


def test_coeff_from_reference_packing():
    """The kernel-argument form: mask[d][b] bit i = bit b of C[i, d];
    top[d] = bits row d needs; padded to the kernel's 64 inputs."""
    c = ref_gf256.parity_matrix(10, 4)
    sc = gf_swar.coeff_from_reference(c)
    assert sc.shape == (4, 10)
    np.testing.assert_array_equal(sc.matrix, c)
    assert len(sc.packed) == gf_swar.MAX_IN * 8 * 2 + gf_swar.MAX_IN
    mask = np.frombuffer(sc.packed[: gf_swar.MAX_IN * 16], "<u2").reshape(
        gf_swar.MAX_IN, 8
    )
    top = np.frombuffer(sc.packed[gf_swar.MAX_IN * 16:], np.uint8)
    for d in range(gf_swar.MAX_IN):
        col = [int(x) for x in c[:, d]] if d < 10 else [0] * 4
        assert top[d] == max(x.bit_length() for x in col)
        for b in range(8):
            want = sum(((col[i] >> b) & 1) << i for i in range(4))
            assert mask[d, b] == want, (d, b)
    # the port's own gf256 gives the same argument form
    assert gf_swar.coeff_from_reference(
        gf256.parity_matrix(10, 4)
    ).packed == sc.packed


def test_oversized_shapes_raise():
    with pytest.raises(ValueError):
        gf_swar.coeff_from_reference(np.ones((17, 10), np.uint8))
    with pytest.raises(ValueError):
        gf_swar.coeff_from_reference(np.ones((4, 65), np.uint8))
    with pytest.raises(ValueError):
        gf_swar.coeff_from_reference(np.ones((0, 10), np.uint8))
    coeff = gf_swar.coeff_from_reference(ref_gf256.parity_matrix(10, 4))
    with pytest.raises(ValueError):  # k mismatch
        gf_swar.gf_matmul(coeff, torch.zeros((9, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):  # wrong dtype
        gf_swar.gf_matmul(coeff, torch.zeros((10, 16), dtype=torch.int32))
    with pytest.raises(ValueError):  # not cuda or cpu
        gf_swar.gf_matmul(
            coeff, torch.zeros((10, 16), dtype=torch.uint8, device="meta")
        )


def test_cpu_tensor_never_launches():
    coeff = ref_gf256.parity_matrix(10, 4)
    before = gf_swar.LAUNCHES.value
    plain(coeff, np.zeros((10, 64), np.uint8))
    assert gf_swar.LAUNCHES.value == before


def test_launch_counter():
    c = gf_swar.LaunchCounter()
    c.add()
    c.add()
    assert c.value == 2
    c.reset()
    assert c.value == 0


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_kernel_matches_plain_on_card():
    dev = torch.device("cuda")
    for k, m in SHAPES:
        coeff = gf_swar.coeff_from_reference(ref_gf256.parity_matrix(k, m))
        for n in RAGGED + [1 << 20]:
            data = torch.from_numpy(
                rng_for("cuda", k, m, n).integers(0, 256, (2, k, n),
                                                  dtype=np.uint8)
            ).to(dev)
            before = gf_swar.LAUNCHES.value
            got = gf_swar.gf_matmul(coeff, data)
            assert gf_swar.LAUNCHES.value == before + 1
            assert torch.equal(got, gf_swar.gf_matmul_plain(coeff, data))
