from recommender_tpu_torch.models.bst import BST
from recommender_tpu_torch.models.dcn import DCN
from recommender_tpu_torch.models.deepfm import DeepFM
from recommender_tpu_torch.models.dien import DIEN, DIN, BaseModel, SequenceBase
from recommender_tpu_torch.models.dlrm import DLRM
from recommender_tpu_torch.models.eges import EGES, GES, DeepWalk
from recommender_tpu_torch.models.esmm import ESMM, MMOE, FeatureEmbedder, MultiTaskBase
from recommender_tpu_torch.models.tasks import (
    evaluate_head,
    init_model,
    link_prediction_auc,
    make_aux_loss_task,
    make_ctr_task,
    make_head_eval,
    make_multitask_task,
    make_skipgram_task,
)

__all__ = [
    "BST",
    "BaseModel",
    "DCN",
    "DeepFM",
    "DeepWalk",
    "DIEN",
    "DIN",
    "DLRM",
    "EGES",
    "ESMM",
    "FeatureEmbedder",
    "GES",
    "MMOE",
    "MultiTaskBase",
    "SequenceBase",
    "evaluate_head",
    "init_model",
    "link_prediction_auc",
    "make_aux_loss_task",
    "make_ctr_task",
    "make_head_eval",
    "make_multitask_task",
    "make_skipgram_task",
]
