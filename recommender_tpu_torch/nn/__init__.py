from recommender_tpu_torch.nn.interactions import DotInteraction, fm_cross
from recommender_tpu_torch.nn.losses import bce_with_logits, binary_cross_entropy
from recommender_tpu_torch.nn.mlp import MLP

__all__ = [
    "DotInteraction",
    "MLP",
    "bce_with_logits",
    "binary_cross_entropy",
    "fm_cross",
]
