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
from .encoder import (  # noqa: F401
    write_ec_files,
    write_ec_files_batch,
    write_sorted_file_from_idx,
)
from .rebuild import rebuild_ec_files  # noqa: F401
from .decoder import (  # noqa: F401
    find_dat_file_size,
    iterate_ecj_file,
    read_ec_volume_version,
    write_dat_file,
    write_idx_file_from_ec_index,
)
