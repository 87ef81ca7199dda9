from recommender_tpu_torch.embedding.table import Embedding

__all__ = ["Embedding"]
