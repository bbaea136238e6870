"""Train state: the model, torch Adam with L2, the per-step LR schedule and
the step count.

The reference optimizer is ``Adam(lr, weight_decay=1e-5)``. torch Adam's
``weight_decay`` adds ``l2 * param`` to the gradient before the moments,
which is the JAX package's ``add_decayed_weights`` ahead of
``scale_by_adam`` (L2, not AdamW).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from sdumc_tpu_torch.core.config import TrainConfig
from sdumc_tpu_torch.train.schedule import make_lr_lambda


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0                   # optimizer steps taken


def make_optimizer(params, lr: float, l2: float = 1e-5) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=l2)


def create_train_state(model: nn.Module, tcfg: TrainConfig, steps_per_epoch: int) -> TrainState:
    optimizer = make_optimizer(model.parameters(), tcfg.lr, tcfg.l2)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, make_lr_lambda(
        steps_per_epoch, tcfg.warmup_epochs, tcfg.decay_gamma, tcfg.decay_stepsize))
    return TrainState(model, optimizer, scheduler)
