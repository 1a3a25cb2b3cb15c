"""``mx.optimizer``: optimizers that update parameters in place, the
Updater and the learning-rate schedulers."""
from .optimizer import (Optimizer, SGD, NAG, Adam, AdaGrad, RMSProp,
                        AdaDelta, Ftrl, SignSGD, Signum, Updater, get_updater,
                        register, create)
from . import lr_scheduler
from .lr_scheduler import LRScheduler

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "SignSGD", "Signum", "Updater", "get_updater",
           "register", "create", "lr_scheduler", "LRScheduler"]
