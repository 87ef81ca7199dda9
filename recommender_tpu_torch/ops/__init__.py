from recommender_tpu_torch.ops.embedding_kernels import (
    embedding_lookup,
    scatter_add_dense,
    sorted_scatter_add,
    sorted_scatter_add_ref,
)
from recommender_tpu_torch.ops.flash_attention import flash_mha, flash_mha_ref

__all__ = [
    "embedding_lookup",
    "flash_mha",
    "flash_mha_ref",
    "scatter_add_dense",
    "sorted_scatter_add",
    "sorted_scatter_add_ref",
]
