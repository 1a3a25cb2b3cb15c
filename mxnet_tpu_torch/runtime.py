"""Runtime feature introspection (reference: python/mxnet/runtime.py over
include/mxnet/libinfo.h:47-146).

The PyTorch counterpart of ``mxnet_tpu/runtime.py``. The keys are the
JAX package's, one for one; the values are the port's truth: ``CUDA``,
``CUDNN`` and ``DIST_KVSTORE`` come from torch, ``TPU``, ``XLA`` and
``PALLAS`` are False, ``COMPILE_CACHE`` is the program disk tier's knob,
and a subsystem the port lacks (``SHARDING``, the eager dispatch cache
behind ``EAGER_JIT``, the native IO library) reads False.
"""
from __future__ import annotations

import platform

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    import torch

    from .analysis import verify_mode
    from .analysis.graph_opt import opt_level
    from .gluon.fused_step import fused_step_enabled
    from .kernels import fusion_enabled
    from .pipeline import pipeline_enabled
    from .resilience import resilience_enabled
    from .serving import serving_enabled
    from .serving.admission import admission_enabled
    from .utils.compile_cache import cache_enabled as compile_cache_enabled

    cuda = torch.cuda.is_available()
    feats = {
        "TPU": False,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "OPENMP": torch.backends.openmp.is_available(),
        "BLAS_OPEN": "BLAS_INFO=open" in torch.__config__.show(),
        "XLA": False,
        "PALLAS": False,
        # the port dispatches each op eagerly: no dispatch executable cache
        "EAGER_JIT": False,
        "FUSED_STEP": fused_step_enabled(),
        # the program disk tier (utils/compile_cache.py)
        "COMPILE_CACHE": compile_cache_enabled(),
        "SERVING": serving_enabled(),
    }
    feats["SERVING_ADMISSION"] = feats["SERVING"] and admission_enabled()
    feats["PIPELINE"] = pipeline_enabled()
    feats["RESILIENCE"] = resilience_enabled()
    feats["GRAPH_VERIFY"] = verify_mode() != "off"
    feats["GRAPH_OPT"] = opt_level() > 0
    feats["FUSION"] = fusion_enabled()
    # sharding/ comes with slice 9b
    feats["SHARDING"] = False
    feats["DIST_KVSTORE"] = torch.distributed.is_available()
    feats["INT64_TENSOR_SIZE"] = True
    # what initialize.install_signal_handlers installed (faulthandler)
    from . import initialize

    feats["SIGNAL_HANDLER"] = initialize.installed()["signals"]
    feats["F16C"] = platform.machine().lower() in ("x86_64", "amd64")
    # the port's native IO library (csrc/recordio.cc) is built and loaded
    from . import _native

    feats["NATIVE_IO"] = _native.io_loaded()
    feats["OPENCV"] = False
    try:
        import PIL  # noqa: F401

        feats["PIL"] = True
    except ImportError:
        feats["PIL"] = False
    return feats


class Features(dict):
    """Reference: runtime.py Features — dict of Feature, is_enabled()."""

    def __init__(self):
        super().__init__([(k, Feature(k, v)) for k, v in _detect().items()])

    def is_enabled(self, name):
        feat = self.get(name)
        return bool(feat and feat.enabled)

    def __repr__(self):
        return str(list(self.values()))


def feature_list():
    return list(Features().values())
