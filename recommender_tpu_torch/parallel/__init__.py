from recommender_tpu_torch.parallel.partitioning import (
    element_offsets,
    row_sharded_params,
    validate_divisibility,
)

__all__ = ["element_offsets", "row_sharded_params", "validate_divisibility"]
