from recommender_tpu_torch.nn.cross import CrossNetwork
from recommender_tpu_torch.nn.interactions import DotInteraction, fm_cross
from recommender_tpu_torch.nn.losses import (
    bce_with_logits,
    binary_cross_entropy,
    margin_loss,
    masked_auxiliary_loss,
    sampled_sigmoid_ce,
)
from recommender_tpu_torch.nn.mlp import MLP, BatchNorm
from recommender_tpu_torch.nn.moe import ExpertBank, MMOEGate
from recommender_tpu_torch.nn.recurrent import AUGRU, GRU
from recommender_tpu_torch.nn.schedules import dlrm_warmup_cosine
from recommender_tpu_torch.nn.sequence import (
    AuxiliaryNet,
    DIENAttention,
    LocalActivationUnit,
    masked_mean_pool,
)
from recommender_tpu_torch.nn.transformer import DenseGeneral, TransformerBlock

__all__ = [
    "AUGRU",
    "AuxiliaryNet",
    "BatchNorm",
    "CrossNetwork",
    "DIENAttention",
    "DenseGeneral",
    "DotInteraction",
    "ExpertBank",
    "GRU",
    "LocalActivationUnit",
    "MLP",
    "MMOEGate",
    "TransformerBlock",
    "bce_with_logits",
    "binary_cross_entropy",
    "dlrm_warmup_cosine",
    "fm_cross",
    "margin_loss",
    "masked_auxiliary_loss",
    "masked_mean_pool",
    "sampled_sigmoid_ce",
]
