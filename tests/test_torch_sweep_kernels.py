"""The TPU sweep kernels of ``tools/exp_dev8.py``, ``tools/exp_dev8b.py``
and ``tools/exp_batched.py``, each run in interpret mode on the CPU
inside a ``pl.pallas_call`` built here around the tools' own kernel
function (nothing in ``tools/`` is changed), against the plain version
of its Hopper counterpart on the same inputs:

- ``repack_kernel`` (exp_dev8) and ``repack_rows`` / ``repack_block``
  (exp_dev8b) give ``gf_repack``'s words, word for word, at the same tile,
  so ``gf_repack`` is their counterpart;
- ``fused_u8_kernel`` (exp_dev8b) gives ``gf_fused_u8``'s output;
- ``_swar_fusedv_kernel`` and ``_swar_kernel`` on the swapped grid
  (exp_batched) give ``gf_swar_fusedv``'s and the batch-fastest launch's.

Tolerance 0: GF(2^8) arithmetic is exact and the repack a permutation.
"""

import functools
import zlib

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
    gf_fused_u8,
    gf_repack,
    gf_swar,
)
from tools import exp_batched, exp_dev8, exp_dev8b  # noqa: E402


def rng_for(*params):
    return np.random.default_rng(zlib.crc32(repr(params).encode()))


def rec_matrix(lost, k=10, m=4):
    present = tuple(i for i in range(k + m) if i not in lost)
    return ref_gf256.reconstruction_matrix(k, m, present)[0]


def run_repack(kernel, data, tile):
    """u8 [k, n] through a tools repack kernel on a grid of tiles, as the
    tools' ``build_repack`` lays it out, in interpret mode."""
    k, n = data.shape
    return np.asarray(pl.pallas_call(
        kernel, grid=(n // tile,),
        in_specs=[pl.BlockSpec((k, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((k, tile // 4), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((k, n // 4), jnp.uint32),
        interpret=True,
    )(data))


REPACKS = [
    pytest.param(exp_dev8.repack_kernel, id="exp_dev8.repack_kernel"),
    pytest.param(exp_dev8b.repack_rows, id="exp_dev8b.repack_rows"),
    pytest.param(exp_dev8b.repack_block, id="exp_dev8b.repack_block"),
]


@pytest.mark.parametrize("kernel", REPACKS)
@pytest.mark.parametrize("k,n,tile", [(10, 4096, 512), (10, 16384, 8192),
                                      (4, 2048, 2048), (3, 1024, 64)])
def test_repack_kernels_give_gf_repack_words(kernel, k, n, tile):
    data = rng_for("repack", k, n, tile).integers(0, 256, (k, n),
                                                  dtype=np.uint8)
    want = run_repack(kernel, data, tile)
    got = gf_repack.repack(torch.from_numpy(data), tile)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def run_fused(coeff, data, tile):
    """``fused_u8_kernel`` over [k, n] in tiles, as ``build_fused`` lays
    it out, in interpret mode."""
    o = coeff.shape[0]
    k, n = data.shape
    kern = functools.partial(exp_dev8b.fused_u8_kernel, coeff)
    return np.asarray(pl.pallas_call(
        kern, grid=(n // tile,),
        in_specs=[pl.BlockSpec((k, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((o, tile), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((o, n), jnp.uint8),
        interpret=True,
    )(data))


@pytest.mark.parametrize("tile", [512, 2048, 8192])
@pytest.mark.parametrize("lost", [None, (0, 5, 11, 13), (3,)])
def test_fused_u8_kernel_gives_gf_fused_u8(tile, lost):
    coeff = (ref_gf256.parity_matrix(10, 4) if lost is None
             else rec_matrix(lost))
    data = rng_for("fused", tile, lost).integers(0, 256, (10, 16384),
                                                 dtype=np.uint8)
    want = run_fused(coeff, data, tile)
    np.testing.assert_array_equal(want, ref_gf256.gf_matmul_cpu(coeff, data))
    got = gf_fused_u8.gf_matmul(coeff, torch.from_numpy(data), tile)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gf_fused_u8.gf_matmul_plain(coeff, torch.from_numpy(data),
                                    tile).numpy(), want)


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3)])
def test_fused_u8_ragged_and_batched(k, m):
    """The port's form on widths the reference's grid cannot take (n not
    a multiple of the tile) and on a batch: the GF product itself."""
    coeff = ref_gf256.parity_matrix(k, m)
    data = rng_for("ragged", k).integers(0, 256, (2, k, 5000),
                                         dtype=np.uint8)
    want = np.stack([ref_gf256.gf_matmul_cpu(coeff, d) for d in data])
    for tile in (4, 100, 2048, 8192):
        got = gf_fused_u8.gf_matmul(coeff, torch.from_numpy(data), tile)
        np.testing.assert_array_equal(got.numpy(), want)


def run_fusedv(coeff, words, tile4):
    """``_swar_fusedv_kernel`` over u32 [V, k, n4], as ``build_fusedv``
    lays it out, in interpret mode."""
    o = coeff.shape[0]
    v, k, n4 = words.shape
    kern = functools.partial(exp_batched._swar_fusedv_kernel, coeff, v)
    return np.asarray(pl.pallas_call(
        kern, grid=(n4 // tile4,),
        in_specs=[pl.BlockSpec((v, k, tile4), lambda i: (0, 0, i))],
        out_specs=pl.BlockSpec((v, o, tile4), lambda i: (0, 0, i)),
        out_shape=jax.ShapeDtypeStruct((v, o, n4), jnp.uint32),
        interpret=True,
    )(words))


def run_swapped(coeff, words, tile4):
    """``_swar_kernel`` on the grid (n / tile, batch) of
    ``build_batched_swapped``, in interpret mode."""
    o = coeff.shape[0]
    v, k, n4 = words.shape
    kern = functools.partial(ref_kernel._swar_kernel, coeff)
    return np.asarray(pl.pallas_call(
        kern, grid=(n4 // tile4, v),
        in_specs=[pl.BlockSpec((1, k, tile4), lambda i, b: (b, 0, i))],
        out_specs=pl.BlockSpec((1, o, tile4), lambda i, b: (b, 0, i)),
        out_shape=jax.ShapeDtypeStruct((v, o, n4), jnp.uint32),
        interpret=True,
    )(words))


FORMS = [
    pytest.param(run_fusedv, gf_swar.gf_matmul_fusedv, id="fusedv"),
    pytest.param(run_swapped, gf_swar.gf_matmul_batch_fastest,
                 id="swapped-grid"),
]


@pytest.mark.parametrize("run_ref,form", FORMS)
@pytest.mark.parametrize("v,tile4,lost", [(1, 512, None), (3, 256, None),
                                          (5, 512, None), (1, 512, (0, 13)),
                                          (2, 256, (0, 5, 11, 13))])
def test_batched_forms(run_ref, form, v, tile4, lost):
    coeff = (ref_gf256.parity_matrix(10, 4) if lost is None
             else rec_matrix(lost))
    words = rng_for("forms", v, tile4, lost).integers(
        0, 1 << 32, (v, 10, 1024), dtype=np.uint32)
    want = run_ref(coeff, words, tile4)
    np.testing.assert_array_equal(want.view(np.uint8), np.stack([
        ref_gf256.gf_matmul_cpu(coeff, w.view(np.uint8)) for w in words]))
    for dtype in (torch.int32, torch.uint32):
        t = torch.from_numpy(words.view(np.int32)).view(dtype)
        got = form(coeff, t)
        assert got.dtype == dtype and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                      want.view(np.int32))


def test_word_forms_ragged_and_errors():
    coeff = ref_gf256.parity_matrix(10, 4)
    words = rng_for("ragged-words").integers(0, 1 << 32, (2, 10, 1001),
                                             dtype=np.uint32)
    want = np.stack([
        ref_gf256.gf_matmul_cpu(coeff, w.view(np.uint8)).view(np.uint32)
        for w in words])
    t = torch.from_numpy(words.view(np.int32))
    for form in (gf_swar.gf_matmul_fusedv, gf_swar.gf_matmul_batch_fastest):
        np.testing.assert_array_equal(
            form(coeff, t).numpy().view(np.uint32), want)
        with pytest.raises(ValueError):
            form(coeff, t[0])  # not [V, k, n4]
        with pytest.raises(ValueError):
            form(coeff, t.view(torch.uint8))  # bytes, not words


def test_fused_u8_rejects_what_the_kernel_does_not_take():
    coeff = ref_gf256.parity_matrix(10, 4)
    x = torch.zeros((10, 64), dtype=torch.uint8)
    for tile in (0, 6, -4):
        with pytest.raises(ValueError):
            gf_fused_u8.gf_matmul(coeff, x, tile)
    with pytest.raises(ValueError):
        gf_fused_u8.gf_matmul(coeff, x.to(torch.int32), 64)
    with pytest.raises(ValueError):
        gf_fused_u8.gf_matmul(coeff, x[:9], 64)
    before = gf_fused_u8.LAUNCHES.value
    gf_fused_u8.gf_matmul(coeff, x, 64)
    assert gf_fused_u8.LAUNCHES.value == before
