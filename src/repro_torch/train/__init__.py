"""Training substrate: AdamW, schedules, train-step factory."""
from repro_torch.train.optim import AdamWConfig, AdamWState, init, lr_at, update
from repro_torch.train.step import make_eval_step, make_train_step

__all__ = ["AdamWConfig", "AdamWState", "init", "lr_at", "update", "make_eval_step",
           "make_train_step"]
