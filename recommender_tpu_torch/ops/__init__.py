from recommender_tpu_torch.ops.embedding_kernels import (
    embedding_lookup,
    embedding_lookup_dedup,
    scatter_add_dense,
    sorted_scatter_add,
    sorted_scatter_add_ref,
)
from recommender_tpu_torch.ops.flash_attention import flash_mha, flash_mha_ref

__all__ = [
    "embedding_lookup",
    "embedding_lookup_dedup",
    "flash_mha",
    "flash_mha_ref",
    "scatter_add_dense",
    "sorted_scatter_add",
    "sorted_scatter_add_ref",
]
