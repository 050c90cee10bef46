from .dist import (
    Mesh,
    init_distributed,
    load_sample_sharded_packed,
    load_sharded_packed,
    plan_byte_shards,
    plan_row_shards,
    sample_sharded_moments,
    shard_byte_ranges,
    sharded_operator,
    snp_mesh,
    tall_sharded_operator,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "load_sample_sharded_packed",
    "load_sharded_packed",
    "plan_byte_shards",
    "plan_row_shards",
    "sample_sharded_moments",
    "shard_byte_ranges",
    "sharded_operator",
    "snp_mesh",
    "tall_sharded_operator",
]
