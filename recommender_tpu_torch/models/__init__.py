from recommender_tpu_torch.models.dlrm import DLRM
from recommender_tpu_torch.models.tasks import init_model, make_ctr_task

__all__ = ["DLRM", "init_model", "make_ctr_task"]
