"""Device counting for the collectives (the PyTorch counterpart of
``mxnet_tpu/parallel/mesh.py:23``; the mesh itself comes with slice
9b)."""
from __future__ import annotations

import torch

__all__ = ["device_count"]


def device_count():
    """The devices the job computes on: one a rank inside a process
    group, else this process's CUDA devices (at least 1: the CPU)."""
    from .. import _rendezvous as rdv

    if rdv.is_initialized():
        return rdv.world_size()
    return max(1, torch.cuda.device_count()) if torch.cuda.is_available() \
        else 1
