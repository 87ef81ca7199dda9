from recommender_tpu_torch.data.pipeline import batch_iterator
from recommender_tpu_torch.data.synthetic import SyntheticCTR, SyntheticSequence

__all__ = ["SyntheticCTR", "SyntheticSequence", "batch_iterator"]
