"""Optimizers of the port (counterpart of ``repro.optim``): SGD with
momentum, Adam and AdamW as (init, update) pairs over trees of tensors,
and the learning-rate schedules."""
from repro_torch.config import TrainConfig
from repro_torch.optim.adam import adam, adamw
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup_cosine)
from repro_torch.optim.sgd import Optimizer, apply_updates, sgd

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "constant",
           "cosine_decay", "from_config", "linear_warmup_cosine", "sgd"]


def from_config(cfg: TrainConfig):
    if cfg.optimizer == "sgd":
        return sgd(cfg.learning_rate, momentum=cfg.momentum)
    if cfg.optimizer == "adam":
        return adam(cfg.learning_rate)
    if cfg.optimizer == "adamw":
        return adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
