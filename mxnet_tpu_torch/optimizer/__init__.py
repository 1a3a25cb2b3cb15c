"""``mx.optimizer``: optimizers that update parameters in place, the
Updater, the learning-rate schedulers and ``contrib``'s
``GroupAdaGrad``."""
from .optimizer import (Optimizer, SGD, NAG, Adam, AdaGrad, RMSProp,
                        AdaDelta, Ftrl, SignSGD, Signum, Adamax, Nadam, FTML,
                        LAMB, LARS, LBSGD, DCASGD, SGLD, Updater, get_updater,
                        register, create)
from . import contrib, lr_scheduler
from .contrib import GroupAdaGrad
from .lr_scheduler import LRScheduler

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "SignSGD", "Signum", "Adamax", "Nadam", "FTML",
           "LAMB", "LARS", "LBSGD", "DCASGD", "SGLD", "GroupAdaGrad",
           "Updater", "get_updater", "register", "create", "contrib",
           "lr_scheduler", "LRScheduler"]
