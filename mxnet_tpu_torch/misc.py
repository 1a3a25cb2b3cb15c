"""Legacy learning-rate schedulers (reference: python/mxnet/misc.py,
the pre-lr_scheduler API some old training scripts import).

The PyTorch counterpart of ``mxnet_tpu/misc.py``. The modern API is
``mx.optimizer.lr_scheduler``."""
from __future__ import annotations


class LearningRateScheduler:
    """Base class (reference misc.py LearningRateScheduler)."""

    def __init__(self):
        self.base_lr = 0.01

    def __call__(self, iteration):
        raise NotImplementedError("must override this")


class FactorScheduler(LearningRateScheduler):
    """Multiply the lr by `factor` every `step` iterations."""

    def __init__(self, step, factor=0.1):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal "
                             "than 1 round")
        if factor >= 1.0:
            raise ValueError("Factor must be less than 1 to make lr "
                             "reduce")
        self.step = step
        self.factor = factor

    def __call__(self, iteration):
        return self.base_lr * (self.factor ** (iteration // self.step))
