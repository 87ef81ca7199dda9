from recommender_tpu_torch.data.pipeline import batch_iterator
from recommender_tpu_torch.data.synthetic import SyntheticCTR

__all__ = ["SyntheticCTR", "batch_iterator"]
