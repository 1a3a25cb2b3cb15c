"""The rendezvous every rank joins, and the backend rule.

``tools/launch.py`` starts the ranks and documents the environment;
this module (imported by ``import mxnet_tpu_torch``, and light enough to
be) joins the process group from it. See ``tools/launch.py`` for the
backend rule and each rank's device.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os

__all__ = ["init", "is_initialized", "backend", "device", "choose_backend",
           "rank", "world_size", "coordinator"]

# what init() chose: backend name and the rank's torch.device
_STATE = {}


def _env(name):
    raw = os.environ.get(name)
    return None if raw in (None, "") else raw


def choose_backend(local_size, on_cpu, cuda_devices):
    """The backend rule: ``"gloo"`` on the CPU or when the host's
    ``local_size`` ranks outnumber its ``cuda_devices``, else
    ``"nccl"``."""
    if on_cpu or local_size > cuda_devices:
        return "gloo"
    return "nccl"


def is_initialized():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def init():
    """Join the process group from the launcher's environment; True when
    the environment was present (and the group is joined), False when
    there is nothing to join. Called by ``import mxnet_tpu_torch``.
    Raises when the environment is incomplete, when the rank asks for a
    CUDA device the host lacks, or when the rendezvous or the backend
    fails."""
    import torch
    import torch.distributed as dist

    from .base import MXNetError

    coord = _env("MXNET_COORDINATOR")
    if not coord:
        return False
    if multiprocessing.parent_process() is not None:
        # a DataLoader worker inherits the launcher's environment but is
        # not a rank: joining with its parent's rank would break the group
        return False
    if is_initialized():
        return True
    nproc, pid = _env("MXNET_NUM_PROCESSES"), _env("MXNET_PROCESS_ID")
    if nproc is None or pid is None:
        raise MXNetError(
            "MXNET_COORDINATOR is set but MXNET_NUM_PROCESSES/"
            "MXNET_PROCESS_ID are not: refusing to join the process group "
            "with a guessed rank (every worker would claim rank 0)")
    world, rank_ = int(nproc), int(pid)
    local_rank = int(_env("MXNET_LOCAL_RANK") or rank_)
    local_size = int(_env("MXNET_LOCAL_SIZE") or world)
    want = (_env("MXNET_DIST_DEVICE") or "gpu").lower()
    if want not in ("cpu", "gpu"):
        raise MXNetError(f"MXNET_DIST_DEVICE={want!r}: 'cpu' or 'gpu'")
    on_cpu = want == "cpu"
    if on_cpu:
        dev = torch.device("cpu")
        ncuda = 0
    else:
        if not torch.cuda.is_available():
            raise MXNetError(
                f"rank {rank_}: no CUDA device; a rank runs on the card "
                "unless MXNET_DIST_DEVICE=cpu asks for the CPU")
        ncuda = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % ncuda)
        torch.cuda.set_device(dev)
    name = choose_backend(local_size, on_cpu, ncuda)
    timeout = datetime.timedelta(
        seconds=float(_env("MXNET_DIST_TIMEOUT") or 300))
    kwargs = {}
    if name == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(name, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank_, timeout=timeout,
                            **kwargs)
    _STATE.update(backend=name, device=dev, coordinator=coord)
    return True


def backend():
    """The backend :func:`init` chose (``"nccl"`` or ``"gloo"``), or None
    in a process outside a group."""
    return _STATE.get("backend") if is_initialized() else None


def device():
    """This rank's Context (``gpu(local_rank % device_count)`` or
    ``cpu()``), or None outside a group."""
    from .context import Context

    if not is_initialized() or "device" not in _STATE:
        return None
    return Context.from_device(_STATE["device"])


def rank():
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def world_size():
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def coordinator():
    """(host, port) of the rendezvous store, or None outside a group."""
    coord = _STATE.get("coordinator")
    if coord is None:
        return None
    host, _, port = coord.rpartition(":")
    return host, int(port)
