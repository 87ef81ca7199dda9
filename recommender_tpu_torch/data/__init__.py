from recommender_tpu_torch.data.pipeline import batch_iterator
from recommender_tpu_torch.data.synthetic import SyntheticCTR, SyntheticMultiTask, SyntheticSequence

__all__ = ["SyntheticCTR", "SyntheticMultiTask", "SyntheticSequence", "batch_iterator"]
