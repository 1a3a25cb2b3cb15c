"""Dynamic loss scaler (reference: python/mxnet/contrib/amp/loss_scaler.py).

The port of ``mxnet_tpu/contrib/amp/loss_scaler.py``. The scale halves
(floor 1.0) on a step whose gradients hold an inf or a NaN, which is
then skipped, and doubles after ``scale_window`` clean steps.

Where the state lives depends on the Trainer's path:

- eager (``MXNET_FUSED_STEP=0``, or an optimizer with no fused kernel):
  in these host fields; :meth:`has_overflow` reads one flag back from
  the device per step, as the JAX package's eager path does;
- the fused step (``gluon/fused_step.py``): on the device, in the
  trainer's step state, which the step updates itself. ``amp.scale_loss``
  then multiplies by that device scale, so a step reads nothing back
  (the JAX package pays one scalar read per step there). The host fields
  lag; reading :attr:`loss_scale` syncs them (one device read), and
  writing it re-seeds the device state at the next step.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self._loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0
        self._device_sync = None  # set by the Trainer while state is on device

    @property
    def loss_scale(self):
        """The current scale as a float (a device read when the Trainer
        holds the state on the device)."""
        if self._device_sync is not None:
            self._device_sync()
        return self._loss_scale

    @loss_scale.setter
    def loss_scale(self, value):
        # the Trainer compares against its seed-time mirror and re-seeds
        # the device state on the next fused step
        self._loss_scale = float(value)

    def has_overflow(self, params):
        """True if any gradient holds an inf or a NaN (reference:
        multi_all_finite, src/operator/contrib/all_finite.cc); one read
        from the device."""
        grads = [p.grad().data for p in params if p.grad_req != "null"]
        if not grads:
            return False
        from ...ndarray import ops_optim

        return not bool(ops_optim.all_finite(*grads).item())

    def update_scale(self, overflow):
        """Halve on overflow; double every ``scale_window`` clean steps."""
        if overflow:
            self._loss_scale = max(1.0,
                                   self._loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self._loss_scale *= self._scale_factor
                self._unskipped = 0

    def __repr__(self):
        return (f"LossScaler(scale={self._loss_scale}, "
                f"factor={self._scale_factor}, window={self._scale_window})")


def _mul(loss, scale):
    """``loss`` (an NDArray) times ``scale`` (a float or a 0-d device
    tensor) on the recorded graph."""
    if isinstance(scale, torch.Tensor):
        return loss._apply(torch.mul, loss.data, scale)
    return loss * scale
