"""The device sweeps of ``tools/exp_dev8.py``, ``tools/exp_dev8b.py`` and
``tools/exp_batched.py``, run on the card through the port's kernels.

Each module keeps its reference's variants and default sizes and is run
as ``python -m seaweedfs_tpu_torch.tools.<name>``; ``main(device=...)``
returns one dict per row. Every row's output is compared byte for byte
with the plain PyTorch version on the same inputs (the reference checked
only some), and on the card it is timed with CUDA events, the L2 flushed
before each call (``ops/timing``); GB/s counts input bytes. Where a TPU
variant has no meaning on the card its row stays, and its label says
why. With ``device="cpu"`` the rows run the plain versions and are
checked but not timed.
"""

from __future__ import annotations

import subprocess

import torch

from .. import resolve_device
from ..ops import timing


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name()}, power limit not read"


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.uint8 else t.contiguous().view(torch.uint8)


class Sweep:
    """Rows of one sweep on one device: each a labelled call, checked
    against the plain version's output and, on the card, timed."""

    def __init__(self, name: str, device, reps: int = 10, seed: int = 0):
        self.name = name
        self.device = resolve_device(device)
        self.reps = reps
        self.rows: list[dict] = []
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self._flush = None
        if self.device.type == "cuda":
            self._flush = timing.l2_flusher(self.device)
            where = card_label()
        else:
            where = "cpu (plain versions; not timed)"
        print(f"{name} on {where}", flush=True)

    def rand_bytes(self, *shape: int) -> torch.Tensor:
        """uint8 random bytes of ``shape`` made on the device from the
        sweep's seed."""
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=self.device, generator=self.gen)

    def row(self, label: str, fn, want: torch.Tensor,
            in_bytes: int) -> dict:
        """Run ``fn()``, compare its output with ``want`` byte for byte and,
        on the card, time it; print and keep the row."""
        got = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        exact = (tuple(got.shape) == tuple(want.shape)
                 and torch.equal(_as_bytes(got), _as_bytes(want)))
        ms = gbps = None
        if self.device.type == "cuda":
            ms = timing.time_ms(fn, self.reps, flush=self._flush)
            gbps = in_bytes / ms / 1e6
        row = {"label": label, "ms": ms, "GBps": gbps, "exact": exact,
               "in_bytes": in_bytes}
        self.rows.append(row)
        speed = ("not timed" if ms is None
                 else f"{ms:9.4f} ms {gbps:9.2f} GB/s")
        print(f"{label:72s} {speed}  byte-exact={exact}", flush=True)
        return row
