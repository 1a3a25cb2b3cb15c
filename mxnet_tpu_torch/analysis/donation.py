"""In-place write safety checks: the port's counterpart of donation.

In the JAX package, buffer donation *deletes* a donated array, and
``mxnet_tpu/analysis/donation.py`` proves at donation time that no
autograd tape node still holds it. Torch deletes no buffer: the port
updates in place (an ``out=`` write, an optimizer update op, the
Trainer's fused step). Its hazard is an in-place write into a tensor
that a live autograd graph saved for backward: the backward would read
the new values (torch raises at backward that a saved tensor was
modified). These checks prove that hazard at write time and name it
with the JAX codes:

- GV201: the written tensor is saved by a live autograd graph;
- GV202: one write's destination also feeds another argument slot of the
  same dispatch, or two parameters share one storage.

Which tensors a live graph saved is known only while
``MXNET_GRAPH_VERIFY`` is on: ``autograd.record()`` then installs
``torch.autograd.graph.saved_tensors_hooks`` (:func:`tracking_saved`),
whose packed boxes live exactly as long as the graph keeps them. Called
from the dispatch (``out=`` writes, ``ndarray/registry.py``) and the
Trainer's step (``gluon/trainer.py``).
"""
from __future__ import annotations

import contextlib
import weakref

import torch

from .diagnostics import DiagnosticReport, verify_mode

__all__ = ["check_dispatch_donation", "check_param_donation",
           "tracking_saved", "storage_key"]

_SAVED = weakref.WeakValueDictionary()  # id(box) -> box


class _Saved:
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


def _pack(t):
    box = _Saved(t)
    _SAVED[id(box)] = box
    return box


def _unpack(box):
    return box.t


@contextlib.contextmanager
def tracking_saved():
    """Record the tensors autograd saves for backward inside the block
    (``autograd.record()`` enters it while verification is on)."""
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield


def storage_key(t):
    """What identifies ``t``'s memory: its storage's device and address
    (the object itself for a tensor with no memory)."""
    ptr = t.untyped_storage().data_ptr() if t.device.type != "meta" else 0
    if not ptr:
        return ("id", id(t))
    return (t.device.type, t.device.index, ptr)


def _saved_holders(keys):
    """storage key -> a description of the live graph's saved tensor that
    holds it, for the keys a live graph saved."""
    held = {}
    for box in list(_SAVED.values()):
        k = storage_key(box.t)
        if k in keys and k not in held:
            held[k] = "a tensor the live autograd graph saved for backward"
    return held


def check_dispatch_donation(opname, arr_args, donate_slot, out):
    """Verify an ``out=`` dispatch may write ``out`` in place.

    GV202: the written buffer also feeds another argument slot of the
    dispatch (``donate_slot`` is ``out``'s own slot among ``arr_args``,
    or None when ``out`` is not an argument). GV201: a live autograd
    graph saved the buffer. Returns the dispositioned report (raises
    under ``error``), or None with verification off."""
    mode = verify_mode()
    if mode == "off":
        return None
    report = DiagnosticReport(subject=opname)
    key = storage_key(out.data)
    for i, a in enumerate(arr_args):
        if i != donate_slot and a is not out and storage_key(a.data) == key:
            report.emit(
                "GV202",
                f"op '{opname}': the out= buffer is also argument slot "
                f"{i}; the write would change a live input",
                node=opname, hint="pass a distinct array for out=")
    holder = _saved_holders({key}).get(key)
    if holder is not None:
        report.emit(
            "GV201",
            f"op '{opname}': the out= buffer is {holder}; backward would "
            "read the written values",
            node=opname,
            hint="run the in-place update outside autograd.record, or "
                 "after backward()")
    return report.disposition(mode)


def check_param_donation(param_arrays, subject="fused_step"):
    """Verify the Trainer's in-place update of ``param_arrays`` ((name,
    tensor) pairs): no parameter may be saved by a live autograd graph
    (GV201) and no two may share one storage (GV202)."""
    mode = verify_mode()
    if mode == "off":
        return None
    report = DiagnosticReport(subject=subject)
    seen = {}
    keys = set()
    for name, data in param_arrays:
        k = storage_key(data)
        keys.add(k)
        prev = seen.get(k)
        if prev is not None:
            report.emit(
                "GV202",
                f"parameters '{prev}' and '{name}' share one storage; "
                "the step would write it twice",
                node=name, hint="give each parameter its own storage")
        else:
            seen[k] = name
    held = _saved_holders(keys)
    for name, data in param_arrays:
        holder = held.get(storage_key(data))
        if holder is not None:
            report.emit(
                "GV201",
                f"parameter '{name}' is updated in place by the step but "
                f"is {holder}",
                node=name, hint="call backward() before step()")
    return report.disposition(mode)
