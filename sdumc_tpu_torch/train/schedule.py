"""LR schedule: linear warmup, then step decay.

The reference's LambdaLR, stepped once per epoch:

    factor(epoch) = (epoch + 1) / warmup        for epoch < warmup
                  = gamma ** ((epoch + 1 - warmup) // stepsize)   otherwise

Here it is stepped once per optimizer step, with the step floored to its
epoch, as the JAX package's optax schedule does. The schedule is read at
the step count before the update, so the first update uses factor(0).
"""

from __future__ import annotations

from typing import Callable


def warmup_step_decay_factor(epoch: int, warmup_epochs: int = 5, gamma: float = 0.9,
                             stepsize: int = 10) -> float:
    """The LambdaLR multiplier of one epoch."""
    if epoch < warmup_epochs:
        return (epoch + 1) / warmup_epochs
    return gamma ** ((epoch + 1 - warmup_epochs) // stepsize)


def make_lr_lambda(steps_per_epoch: int, warmup_epochs: int = 5, gamma: float = 0.9,
                   stepsize: int = 10) -> Callable[[int], float]:
    """step -> multiplier, for ``torch.optim.lr_scheduler.LambdaLR``."""
    def factor(step: int) -> float:
        return warmup_step_decay_factor(step // max(steps_per_epoch, 1), warmup_epochs,
                                        gamma, stepsize)

    return factor
