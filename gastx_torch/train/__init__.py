from gastx_torch.train.checkpoint import (load_checkpoint,
                                          restore_batcher_random_state,
                                          save_checkpoint)
from gastx_torch.train.loop import eval_step, train_step
from gastx_torch.train.optimizer import (exponential_epoch_decay,
                                         make_optimizer, set_lr)

__all__ = ["load_checkpoint", "restore_batcher_random_state",
           "save_checkpoint", "eval_step", "train_step",
           "exponential_epoch_decay", "make_optimizer", "set_lr"]
