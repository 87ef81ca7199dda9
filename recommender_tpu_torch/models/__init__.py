from recommender_tpu_torch.models.bst import BST
from recommender_tpu_torch.models.dien import SequenceBase
from recommender_tpu_torch.models.dlrm import DLRM
from recommender_tpu_torch.models.tasks import init_model, make_ctr_task

__all__ = ["BST", "DLRM", "SequenceBase", "init_model", "make_ctr_task"]
