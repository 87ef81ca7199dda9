from recommender_tpu_torch.embedding.planner import TableStats, plan_tables
from recommender_tpu_torch.embedding.sharded import (
    all_to_all_lookup,
    shard_table,
    sharded_lookup,
    sort_coalesced_lookup,
)
from recommender_tpu_torch.embedding.table import Embedding, EmbeddingSpec

__all__ = [
    "Embedding",
    "EmbeddingSpec",
    "TableStats",
    "all_to_all_lookup",
    "plan_tables",
    "shard_table",
    "sharded_lookup",
    "sort_coalesced_lookup",
]
