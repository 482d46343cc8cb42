"""The ``.vif`` volume-info file and the offset-width guard.

The port's copy of the part of ``seaweedfs_tpu/storage/backend.py``
(:310-345) that ``ec_volume.EcVolume`` uses: the ``.vif`` is JSON (the
analog of SeaweedFS's weed/pb/volume_info.go), and a volume stamps in it
the idx/ecx offset width it was written with. The tiered backends (HTTP
range, S3) are not part of the port yet.
"""

from __future__ import annotations

import json
import os

from . import types as t


def volume_offset_width(base_file_name: str) -> int:
    """The idx/ecx offset width this volume was written with, from its
    .vif stamp; a missing stamp means the legacy/default 4 bytes."""
    return int(
        load_volume_info(base_file_name).get("offset_size") or 4
    )


def check_volume_offset_width(
    base_file_name: str, what: str
) -> None:
    """Refuse to open width-mismatched volume files — misparsing a
    16-byte-entry index as 17 (or vice versa) corrupts silently, the
    reference's 5BytesOffset build-tag mismatch failure mode."""
    vif_osz = volume_offset_width(base_file_name)
    if vif_osz != t.OFFSET_SIZE:
        raise RuntimeError(
            f"{what}: written with {vif_osz}-byte offsets but this "
            f"process runs {t.OFFSET_SIZE}-byte (WEED_LARGE_DISK "
            "mismatch)"
        )


def load_volume_info(base_file_name: str) -> dict:
    path = base_file_name + ".vif"
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def save_volume_info(base_file_name: str, info: dict) -> None:
    with open(base_file_name + ".vif", "w") as f:
        json.dump(info, f)
