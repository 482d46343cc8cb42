"""Erasure coding: RS(10,4) striped volumes on the port's CUDA codec.

Layout, encoder and rebuild mirror ``seaweedfs_tpu.storage.
erasure_coding`` on disk byte for byte; the GF math runs through
``ops.codec.RSCodec``; ``write_ec_files_batch`` encodes many volumes at
once on one card; the decoder turns the data shards back into a
``.dat`` and the ``.ecx``/``.ecj`` into an ``.idx`` (``ec.decode``).
"""

from .constants import (  # noqa: F401
    DATA_SHARDS,
    PARITY_SHARDS,
    TOTAL_SHARDS,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    to_ext,
)
from .layout import (  # noqa: F401
    Interval,
    encode_row_plan,
    locate_data,
    shard_file_size,
    to_shard_id_and_offset,
)
from .decoder import (  # noqa: F401
    find_dat_file_size,
    iterate_ecj_file,
    read_ec_volume_version,
    write_dat_file,
    write_idx_file_from_ec_index,
)

# the encoder and the rebuild import torch; a client that only needs the
# constants or the layout (``weed shell``, through the maintenance plane)
# starts without it
_LAZY = {
    "write_ec_files": "encoder",
    "write_ec_files_batch": "encoder",
    "write_sorted_file_from_idx": "encoder",
    "rebuild_ec_files": "rebuild",
}


def __getattr__(name: str):
    """The encoder's and the rebuild's public names, imported at first
    use."""
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value
