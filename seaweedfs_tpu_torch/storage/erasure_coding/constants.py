"""EC constants (SeaweedFS weed/storage/erasure_coding/ec_encoder.go:17-23)."""

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS

LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1 GiB striping rows while >10 GiB left
SMALL_BLOCK_SIZE = 1024 * 1024  # 1 MiB rows for the tail


def to_ext(shard_id: int) -> str:
    """Shard file extension: .ec00 … .ec13."""
    return f".ec{shard_id:02d}"
