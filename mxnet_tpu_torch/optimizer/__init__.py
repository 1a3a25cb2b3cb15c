"""``mx.optimizer``: optimizers that update parameters in place."""
from .optimizer import SGD, Adam, Optimizer, create, register

__all__ = ["Optimizer", "register", "create", "SGD", "Adam"]
