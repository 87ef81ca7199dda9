from recommender_tpu_torch.core.metrics import StreamingAUC, auc_from_state
from recommender_tpu_torch.core.train import TrainConfig, Trainer, TrainState

__all__ = ["StreamingAUC", "TrainConfig", "TrainState", "Trainer", "auc_from_state"]
