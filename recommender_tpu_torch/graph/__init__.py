from recommender_tpu_torch.graph.store import WeightedGraph
from recommender_tpu_torch.graph.walks import (
    LogUniformSampler,
    random_walk,
    skipgram_batches,
    skipgram_pairs,
)

__all__ = ["LogUniformSampler", "WeightedGraph", "random_walk", "skipgram_batches",
           "skipgram_pairs"]
