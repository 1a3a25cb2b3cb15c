"""Collectives across the ranks of a process group.

The PyTorch counterpart of ``mxnet_tpu/parallel/`` for data parallelism
over processes (reference: src/kvstore/comm.h, kvstore_nccl.h): each
rank is a process with one device, joined by
``mxnet_tpu_torch.tools.launch``, and the collectives are
``torch.distributed``'s over NCCL or gloo (the backend rule is in
``tools/launch.py``).

Only the collectives are here: ``all_reduce``, ``all_reduce_coalesced``
and ``group_all_reduce``, and ``device_count``. The single-controller
mesh of the JAX package (``make_mesh``, ``mesh_scope``, ``SPMDTrainer``,
``shard_batch``, ``replicate``, ``shard_params``, ring and Ulysses
attention, the mixture of experts, the pipeline and the sharded
checkpoints) comes with slice 9b.
"""
from __future__ import annotations

from .mesh import device_count
from .spmd import all_reduce, all_reduce_coalesced, group_all_reduce

__all__ = ["all_reduce", "all_reduce_coalesced", "group_all_reduce",
           "device_count"]
