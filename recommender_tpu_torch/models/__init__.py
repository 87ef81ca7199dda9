from recommender_tpu_torch.models.bst import BST
from recommender_tpu_torch.models.dcn import DCN
from recommender_tpu_torch.models.deepfm import DeepFM
from recommender_tpu_torch.models.dien import DIEN, DIN, BaseModel, SequenceBase
from recommender_tpu_torch.models.dlrm import DLRM
from recommender_tpu_torch.models.tasks import init_model, make_aux_loss_task, make_ctr_task

__all__ = [
    "BST",
    "BaseModel",
    "DCN",
    "DeepFM",
    "DIEN",
    "DIN",
    "DLRM",
    "SequenceBase",
    "init_model",
    "make_aux_loss_task",
    "make_ctr_task",
]
