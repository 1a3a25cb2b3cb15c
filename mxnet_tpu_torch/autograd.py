"""Autograd scopes.

The PyTorch counterpart of ``mxnet_tpu/autograd.py:76-129``: the
training flag and the recording scopes the serving and model code
reads. ``pause`` stops recording, which here means torch's grad mode
is off inside it. The tape (``record``, ``backward``) comes with the
training slice.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["is_recording", "is_training", "pause", "train_mode",
           "predict_mode"]


class _AutogradState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _AutogradState()


def is_recording():
    """Reference: python/mxnet/autograd.py is_recording."""
    return _STATE.recording


def is_training():
    """Reference: python/mxnet/autograd.py is_training."""
    return _STATE.training


@contextmanager
def _scope(recording=None, training=None):
    prev_r, prev_t = _STATE.recording, _STATE.training
    if recording is not None:
        _STATE.recording = recording
    if training is not None:
        _STATE.training = training
    try:
        if recording is False:
            with torch.no_grad():
                yield
        else:
            yield
    finally:
        _STATE.recording, _STATE.training = prev_r, prev_t


def pause(train_mode=False):
    """Reference: python/mxnet/autograd.py:141 pause()."""
    return _scope(recording=False, training=train_mode)


def train_mode():
    """Reference: python/mxnet/autograd.py:163."""
    return _scope(training=True)


def predict_mode():
    """Reference: python/mxnet/autograd.py:181."""
    return _scope(training=False)
