from recommender_tpu_torch.ops.embedding_kernels import (
    embedding_lookup,
    scatter_add_dense,
    sorted_scatter_add,
    sorted_scatter_add_ref,
)

__all__ = [
    "embedding_lookup",
    "scatter_add_dense",
    "sorted_scatter_add",
    "sorted_scatter_add_ref",
]
