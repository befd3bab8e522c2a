from repro_torch.training.optimizer import adamw_init, adamw_update, OptState
from repro_torch.training.train_loop import (cross_entropy_loss,
                                             make_train_step,
                                             make_whisper_train_step)

__all__ = ["adamw_init", "adamw_update", "OptState", "cross_entropy_loss",
           "make_train_step", "make_whisper_train_step"]
