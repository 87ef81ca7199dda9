from recommender_tpu_torch.nn.interactions import DotInteraction, fm_cross
from recommender_tpu_torch.nn.losses import bce_with_logits, binary_cross_entropy
from recommender_tpu_torch.nn.mlp import MLP, BatchNorm
from recommender_tpu_torch.nn.sequence import masked_mean_pool
from recommender_tpu_torch.nn.transformer import DenseGeneral, TransformerBlock

__all__ = [
    "BatchNorm",
    "DenseGeneral",
    "DotInteraction",
    "MLP",
    "TransformerBlock",
    "bce_with_logits",
    "binary_cross_entropy",
    "fm_cross",
    "masked_mean_pool",
]
