"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu for one
NVIDIA H100.

The package mirrors ``seaweedfs_tpu``'s module paths, so the counterpart
of any module sits at the same relative path. It imports ``torch`` and
numpy, never ``jax`` and nothing of ``seaweedfs_tpu``: what it needs of
the reference's host-only modules (GF tables, ``.idx`` parsing, striping
layout) it keeps as its own copies.

Entry points take an explicit ``device``. ``None`` means the card: when
no CUDA device is present they raise instead of running on the CPU.
Only an explicit ``device="cpu"`` selects the plain PyTorch versions of
the kernels, which is what the CPU test suite does.

``torch`` is imported by the modules that compute and by the two
functions below, not here: a ``weed`` client subcommand (``upload``,
``filer.copy``, ``filer.cat``) starts without it.
"""

from __future__ import annotations

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The CUDA device entry points run on when the caller names none.

    Raises ``RuntimeError`` when no card is present: the port never
    drops to the CPU on its own."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Normalise an entry point's ``device`` argument: ``None`` is
    :func:`default_device`, ``"cpu"`` the plain versions, ``"cuda[:i]"``
    a card that must exist. Any other device type raises."""
    import torch

    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
