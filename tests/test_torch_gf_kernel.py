"""The port's device-resident GF(2^8) product by route, held against the
JAX package's ``gf_matmul_pallas`` run in interpret mode on the same
inputs (the cases of tests/test_pallas_kernel.py), and its contract.

On the CPU every route runs its kernels' plain versions; the CUDA cases
run the kernels themselves against those plain versions and skip here.
Tolerance 0 everywhere: GF(2^8) arithmetic is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")
# the suite runs in parallel workers on shared cores: two threads each
torch.set_num_threads(2)

from seaweedfs_tpu.ops import gf256 as ref_gf256  # noqa: E402
from seaweedfs_tpu.ops.pallas import gf_kernel as ref_kernel  # noqa: E402
from seaweedfs_tpu_torch.ops.kernels import (  # noqa: E402
    gf_bitplane,
    gf_kernel,
    gf_repack,
    gf_swar,
    gf_swar_u8,
    gf_vpu,
)

METHODS = ["repack", "swar", "mxu"]  # vpu: tests/test_torch_gf_vpu.py
COUNTERS = [gf_swar.LAUNCHES, gf_repack.REPACK_LAUNCHES,
            gf_repack.UNPACK_LAUNCHES, gf_swar_u8.LAUNCHES,
            gf_bitplane.LAUNCHES, gf_vpu.LAUNCHES]
needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def rng_for(*params):
    import zlib

    return np.random.default_rng(zlib.crc32(repr(params).encode()))


def reference(coeff, data, method, **kw):
    """The reference's device route: a jax array on the CPU backend."""
    return np.asarray(ref_kernel.gf_matmul_pallas(
        coeff, jax.device_put(data), method=method, **kw))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n", [1000, 2000, 4096, 65536 + 512])
def test_routes_match_reference(method, batched, n):
    k, m = 10, 4
    shape = (2, k, n) if batched else (k, n)
    data = rng_for(method, batched, n).integers(0, 256, shape, dtype=np.uint8)
    coeff = ref_gf256.parity_matrix(k, m)
    got = gf_kernel.gf_matmul_fused(coeff, torch.from_numpy(data),
                                    method=method)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert tuple(got.shape) == shape[:-2] + (m, n)
    np.testing.assert_array_equal(got.numpy(), reference(coeff, data, method))


@pytest.mark.parametrize("method", METHODS)
def test_tile_256_and_reconstruction(method):
    k, m, n = 10, 4, 1000
    data = rng_for("tile", method).integers(0, 256, (k, n), dtype=np.uint8)
    parity = ref_gf256.encode_cpu(data, m)
    shards = np.concatenate([data, parity])
    present = [i for i in range(k + m) if i not in (1, 4, 12)]
    r, missing = ref_gf256.reconstruction_matrix(k, m, tuple(present))
    stack = shards[present[:k]]
    got = gf_kernel.gf_matmul_fused(r, torch.from_numpy(stack),
                                    method=method, tile_n=256)
    np.testing.assert_array_equal(got.numpy(), shards[missing])
    np.testing.assert_array_equal(
        got.numpy(), reference(r, stack, method, tile_n=256))


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (20, 4)])
def test_u32_route_matches_reference(k, m):
    n = 4096
    data = rng_for("u32", k, m).integers(0, 256, (k, n), dtype=np.uint8)
    coeff = ref_gf256.parity_matrix(k, m)
    want = reference(coeff, data.view("<u4"), None)
    for dtype in (np.int32, np.uint32):
        t = torch.from_numpy(data.view(dtype))
        got = gf_kernel.gf_matmul_fused(coeff, t)
        assert got.dtype == t.dtype and tuple(got.shape) == (m, n // 4)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_u32_route_ragged_and_batched():
    k, m, n = 10, 4, 4 * 360
    data = rng_for("u32b").integers(0, 256, (2, k, n), dtype=np.uint8)
    coeff = ref_gf256.parity_matrix(k, m)
    d32 = data.view("<u4").reshape(2, k, n // 4)
    got = gf_kernel.gf_matmul_fused(coeff, torch.from_numpy(d32.view(np.int32)))
    assert tuple(got.shape) == (2, m, n // 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  reference(coeff, d32, None))


@pytest.mark.parametrize("method", ["swar", "mxu"])
def test_host_route(method):
    k, m, n = 10, 4, 5000
    data = rng_for("host", method).integers(0, 256, (k, n), dtype=np.uint8)
    coeff = ref_gf256.parity_matrix(k, m)
    got = gf_kernel.gf_matmul_fused(coeff, data, method=method, device="cpu")
    assert isinstance(got, np.ndarray)
    want = np.asarray(ref_kernel.gf_matmul_pallas(coeff, data, method=method))
    np.testing.assert_array_equal(got, want)
    if method == "swar":
        later = gf_kernel.gf_matmul_fused(coeff, data, defer=True,
                                          device="cpu")
        assert callable(later)
        np.testing.assert_array_equal(later(), want)


@pytest.mark.parametrize("k,n,tile", [(10, 2048, 512), (3, 1000, 256),
                                      (2, 5, 4), (4, 100, 64),
                                      (10, 65536 + 512, 65536)])
def test_repack_layout_matches_reference_kernel(k, n, tile):
    """The plain repack's u32 words are the reference kernel's, word for
    word, and the plain unpack is its inverse, as the reference's is."""
    data = rng_for("layout", k, n).integers(0, 256, (k, n), dtype=np.uint8)
    n_pad = gf_repack.padded_width(n, tile)
    padded = np.pad(data, ((0, 0), (0, n_pad - n)))
    grid = (n_pad // tile,)
    want = pl.pallas_call(
        ref_kernel._repack_block_kernel, grid=grid,
        in_specs=[pl.BlockSpec((k, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((k, tile // 4), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((k, n_pad // 4), jnp.uint32),
        interpret=True,
    )(padded)
    words = gf_repack.repack(torch.from_numpy(data), tile)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(want))
    back = pl.pallas_call(
        ref_kernel._unpack_block_kernel, grid=grid,
        in_specs=[pl.BlockSpec((k, tile // 4), lambda i: (0, i))],
        out_specs=pl.BlockSpec((k, tile), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((k, n_pad), jnp.uint8),
        interpret=True,
    )(want)
    got = gf_repack.unpack(words, tile, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(back)[:, :n])
    np.testing.assert_array_equal(got.numpy(), data)


def test_choose_tile_is_the_references():
    for total, want in [(1, 4), (5, 4), (8, 8), (1000, 512), (65536, 65536),
                        (10 ** 9, 65536)]:
        assert gf_repack.choose_tile(total) == want
    assert gf_repack.choose_tile(1000, 256) == 256


def test_strided_rows_need_no_copy():
    """The swar and mxu routes take rows as they lie: the first 10 rows
    of a [14, N] tensor, a ragged N."""
    shards = torch.from_numpy(
        rng_for("strided").integers(0, 256, (14, 4099), dtype=np.uint8))
    coeff = ref_gf256.parity_matrix(10, 4)
    want = ref_gf256.gf_matmul_cpu(coeff, shards[:10].numpy())
    for method in METHODS + ["vpu"]:
        got = gf_kernel.gf_matmul_fused(coeff, shards[:10], method=method)
        np.testing.assert_array_equal(got.numpy(), want)


def test_default_route_uses_the_autotuner_default():
    data = rng_for("default").integers(0, 256, (10, 1024), dtype=np.uint8)
    coeff = ref_gf256.parity_matrix(10, 4)
    got = gf_kernel.gf_matmul_fused(coeff, torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(),
                                  ref_gf256.gf_matmul_cpu(coeff, data))


def test_contract_errors():
    coeff = ref_gf256.parity_matrix(10, 4)
    u8 = torch.zeros((10, 128), dtype=torch.uint8)
    u32 = torch.zeros((10, 32), dtype=torch.int32)
    for method in ("mxu", "repack"):
        with pytest.raises(ValueError):
            gf_kernel.gf_matmul_fused(coeff, u32, method=method)
    with pytest.raises(ValueError):  # the reference's own check
        ref_kernel.gf_matmul_pallas(coeff, jnp.zeros((10, 32), jnp.uint32),
                                    method="mxu")
    with pytest.raises(ValueError):
        gf_kernel.gf_matmul_fused(coeff, u8, defer=True)
    with pytest.raises(ValueError):
        gf_kernel.gf_matmul_fused(coeff, np.zeros((10, 128), np.uint8),
                                  method="mxu", defer=True, device="cpu")
    with pytest.raises(ValueError):
        gf_kernel.gf_matmul_fused(coeff, u8, method="nope")
    with pytest.raises(ValueError):
        gf_kernel.gf_matmul_fused(coeff, np.zeros((10, 128), np.uint8),
                                  method="repack", device="cpu")
    with pytest.raises(ValueError):
        gf_kernel.gf_matmul_fused(coeff, u8, device="cpu")
    with pytest.raises(ValueError):
        gf_kernel.gf_matmul_fused(coeff, u8.to(torch.int16))
    # the vpu route: u8 only, no defer, the product itself
    with pytest.raises(ValueError):
        gf_kernel.gf_matmul_fused(coeff, u32, method="vpu")
    with pytest.raises(ValueError):
        gf_kernel.gf_matmul_fused(coeff, np.zeros((10, 128), np.uint8),
                                  method="vpu", defer=True, device="cpu")
    x = rng_for("contract-vpu").integers(0, 256, (10, 128), dtype=np.uint8)
    got = gf_kernel.gf_matmul_fused(coeff, torch.from_numpy(x), method="vpu")
    np.testing.assert_array_equal(got.numpy(),
                                  ref_gf256.gf_matmul_cpu(coeff, x))


def test_host_input_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coeff = ref_gf256.parity_matrix(10, 4)
    with pytest.raises(RuntimeError):
        gf_kernel.gf_matmul_fused(coeff, np.zeros((10, 64), np.uint8))


def test_cpu_tensors_never_launch():
    coeff = ref_gf256.parity_matrix(10, 4)
    before = [c.value for c in COUNTERS]
    x = torch.zeros((10, 256), dtype=torch.uint8)
    for method in METHODS + ["vpu"]:
        gf_kernel.gf_matmul_fused(coeff, x, method=method)
    gf_kernel.gf_matmul_fused(coeff, x.view(torch.int32))
    assert [c.value for c in COUNTERS] == before


def test_bitplane_fragments():
    """The kernel's A operand: expand_bitmatrix with its rows and columns
    in the lane pack's order, bit j weighed by 2^(7-j) as an int8, cut into
    mma.m16n8k32 fragments: lane 4g+t, register r holding A[16mt + g +
    8(r&1), 32ks + 16(r>>1) + 4t + i]. At MT = 2 row g + 8h of m-tile mt is
    bit 4(g>>2) + 2mt + h of output g&3; column kappa of slice ks is bit
    (kappa&3) + 4(kappa>>4) of input 4ks + ((kappa&15)>>2)."""
    from seaweedfs_tpu.ops import bitmatrix as ref_bitmatrix

    coeff = ref_gf256.parity_matrix(6, 3)  # MT = 2, KS = 2
    frags = gf_bitplane.fragment_bitmatrix(coeff)
    assert frags.shape == (2, 2, 32, 4, 4) and frags.dtype == np.int8
    bits = ref_bitmatrix.expand_bitmatrix(coeff)
    for mt, ks, lane, r, i in np.ndindex(frags.shape):
        g, t = lane >> 2, lane & 3
        rho, kappa = g + 8 * (r & 1), 16 * (r >> 1) + 4 * t + i
        out, bit = (rho & 7) & 3, 4 * ((rho & 7) >> 2) + 2 * mt + (rho >> 3)
        d, j = 4 * ks + ((kappa & 15) >> 2), (kappa & 3) + 4 * (kappa >> 4)
        want = bits[8 * out + bit, 8 * d + j] << (7 - j) if (
            out < 3 and d < 6) else 0
        assert frags[mt, ks, lane, r, i] == np.uint8(want).view(np.int8)


@needs_card
@pytest.mark.parametrize("method", METHODS)
def test_routes_on_card_match_plain(method):
    dev = torch.device("cuda")
    coeff = ref_gf256.parity_matrix(10, 4)
    for shape in [(10, 1), (10, 4095), (2, 10, 65536 + 3)]:
        x = torch.from_numpy(
            rng_for("card", method, shape).integers(0, 256, shape,
                                                    dtype=np.uint8))
        got = gf_kernel.gf_matmul_fused(coeff, x.to(dev), method=method)
        want = gf_kernel.gf_matmul_fused(coeff, x, method=method)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
