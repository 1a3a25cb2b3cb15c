"""AMP (reference: python/mxnet/contrib/amp/__init__.py)."""
from .amp import (init, disable, init_trainer, scale_loss, convert_model,
                  convert_hybrid_block, convert_symbol)
from .loss_scaler import LossScaler
from . import lists

__all__ = ["init", "disable", "init_trainer", "scale_loss", "convert_model",
           "convert_hybrid_block", "convert_symbol", "LossScaler", "lists"]
