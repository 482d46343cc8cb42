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

Each launch takes gf_swar's two choices (``gf_swar.launch_plan`` over
the row's 16-byte column words, rounded up): the compile-time RS(10,4)
parity form for a coefficient marked ``rs10x4``, counted in
:data:`RS10X4_LAUNCHES`, the run-time form for every other matrix; and
the column words a thread takes (W).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, gf_swar

KERNEL = gf_swar.RowsKernel("gf_swar_u8", (ctypes.c_int, ctypes.c_int),
                            forms=True)
LAUNCHES = KERNEL.launches
# launches that took the compile-time RS(10,4) parity form
RS10X4_LAUNCHES = build.LaunchCounter()
library = KERNEL.library


def gf_matmul_plain(coeff, data: torch.Tensor) -> torch.Tensor:
    """The plain version: gf_swar's on a contiguous copy."""
    return gf_swar.gf_matmul_plain(coeff, data.contiguous())


def launch_plan(coeff: gf_swar.SwarCoeff, data: torch.Tensor,
                sms: int) -> tuple[int, int]:
    """(W, form) of the launch for ``data`` [..., k, N] on a card of
    ``sms`` SMs: gf_swar's plan over ceil(N / 16) column words in each of
    the batch's slices."""
    n = data.shape[-1] if data.dim() else 0
    batch = int(np.prod(data.shape[:-2]))
    return gf_swar.launch_plan(coeff, -(-n // gf_swar.QUANTUM), batch, sms)


def gf_matmul(coeff: gf_swar.SwarCoeff | np.ndarray, data: torch.Tensor, *,
              width: int | None = None) -> torch.Tensor:
    """out[..., o, N] = coeff ∘GF data[..., k, N] for a uint8 tensor whose
    rows may be strided and N ragged. A CPU tensor goes through
    :func:`gf_matmul_plain`; a CUDA tensor launches the kernel on the
    current stream, at :func:`launch_plan`'s W unless ``width`` is given
    (to time or check one W against another)."""
    if not isinstance(coeff, gf_swar.SwarCoeff):
        coeff = gf_swar.coeff_from_reference(coeff)
    if data.device.type == "cpu":
        return gf_matmul_plain(coeff, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_swar_u8 runs on cuda or cpu, not {data.device}")
    w, form = launch_plan(coeff, data, gf_swar.sm_count(data.device.index))
    if width is not None:
        widest = gf_swar.max_width(coeff.shape[0], form)
        if not 1 <= width <= widest:
            raise ValueError(f"width {width} outside 1..{widest} for "
                             f"{coeff.shape[0]} outputs in form {form}")
        w = width
    out = KERNEL(coeff, data, w, form)
    if data.shape[-1] and form == gf_swar.FORM_RS10X4:
        RS10X4_LAUNCHES.add()
    return out
