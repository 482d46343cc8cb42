"""GF(2^8) matrix product straight from u8 rows of any width and row
stride: the wrapper of the Hopper kernel ``csrc/gf_swar_u8.cu``.

Counterpart of ``seaweedfs_tpu/ops/pallas/gf_kernel.py``
``_gf_matmul_swar_u8_device`` (:516) and its kernel ``_swar_u8_kernel``
(:202): method ``"swar"`` on a device-u8 slab. The plain version is
``gf_swar.gf_matmul_plain`` on a contiguous copy of the input. A CPU
tensor goes through it, a CUDA tensor launches the kernel or raises.

The route makes no copy of its input: a ragged width and strided rows
(the first k rows of a [k+m, N] shard tensor) go to the kernel as they
lie, and the output is a new contiguous [..., o, N] tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf_swar

KERNEL = gf_swar.RowsKernel("gf_swar_u8")
LAUNCHES = KERNEL.launches
library = KERNEL.library


def gf_matmul_plain(coeff, data: torch.Tensor) -> torch.Tensor:
    """The plain version: gf_swar's on a contiguous copy."""
    return gf_swar.gf_matmul_plain(coeff, data.contiguous())


def gf_matmul(coeff: gf_swar.SwarCoeff | np.ndarray,
              data: torch.Tensor) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] for a uint8 tensor whose
    rows may be strided and N ragged. A CPU tensor goes through
    :func:`gf_matmul_plain`; a CUDA tensor launches the kernel on the
    current stream."""
    if not isinstance(coeff, gf_swar.SwarCoeff):
        coeff = gf_swar.coeff_from_reference(coeff)
    if data.device.type == "cpu":
        return gf_matmul_plain(coeff, data)
    return KERNEL(coeff, data)
