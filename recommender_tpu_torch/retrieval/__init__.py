from recommender_tpu_torch.retrieval.scoring import make_scorer, score_batches

__all__ = ["make_scorer", "score_batches"]
