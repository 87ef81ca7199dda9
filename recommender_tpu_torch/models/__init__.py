from recommender_tpu_torch.models.bst import BST
from recommender_tpu_torch.models.dcn import DCN
from recommender_tpu_torch.models.deepfm import DeepFM
from recommender_tpu_torch.models.dien import DIEN, DIN, BaseModel, SequenceBase
from recommender_tpu_torch.models.dlrm import DLRM
from recommender_tpu_torch.models.eges import EGES, GES, DeepWalk
from recommender_tpu_torch.models.esmm import ESMM, MMOE, FeatureEmbedder, MultiTaskBase
from recommender_tpu_torch.models.pinsage import Convolve, FeatureProjector, ItemFeatures, PinSage
from recommender_tpu_torch.models.pinsage_task import make_pinsage_task, pinsage_train_batches
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
from recommender_tpu_torch.models.two_tower import (
    TwoTower,
    corpus_item_reprs,
    interaction_batches,
    make_two_tower_task,
)

__all__ = [
    "BST",
    "BaseModel",
    "Convolve",
    "DCN",
    "DeepFM",
    "DeepWalk",
    "DIEN",
    "DIN",
    "DLRM",
    "EGES",
    "ESMM",
    "FeatureEmbedder",
    "FeatureProjector",
    "GES",
    "ItemFeatures",
    "MMOE",
    "MultiTaskBase",
    "PinSage",
    "SequenceBase",
    "TwoTower",
    "corpus_item_reprs",
    "evaluate_head",
    "init_model",
    "interaction_batches",
    "link_prediction_auc",
    "make_aux_loss_task",
    "make_ctr_task",
    "make_head_eval",
    "make_multitask_task",
    "make_pinsage_task",
    "make_skipgram_task",
    "make_two_tower_task",
    "pinsage_train_batches",
]
