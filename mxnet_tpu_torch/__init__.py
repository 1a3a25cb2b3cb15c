"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module layout and
public names, built on PyTorch for an NVIDIA H100. Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a
kernel written by hand in CUDA C++ under ``csrc/``, built with ``nvcc``
at first use (``kernels/_build.py``), and the runtime-kernel launcher
``rtc.CudaModule`` compiles a user's CUDA C++ with NVRTC. Four slices
are ported: stateful decode serving of :class:`~.models.DecoderBlockLM`,
training :class:`~.models.TransformerLM`, serving an exported symbol
graph through the graph optimizer and its fusion pass, and training
ResNet-50 v1 with a custom-op loss head whose kernels ``rtc`` compiles:

- ``mx.nd`` — NDArray over a ``torch.Tensor`` and the ops both paths
  use;
- ``mx.autograd`` — recording scopes and the tape (torch's autograd
  graph, with MXNet's ``grad_req`` rules);
- ``mx.gluon`` — Block/HybridBlock as ``torch.nn.Module``s, the layers
  (dense, conv and transposed conv, pooling, norms, activations,
  lambdas), ``contrib.nn``, the losses, ``utils``, the Trainer and the
  vision model zoo (ResNet V1/V2, AlexNet, VGG, SqueezeNet, MobileNet
  v1/v2, DenseNet, Inception v3);
- ``mx.optimizer`` — the optimizers with a fused multi-tensor kernel
  (SGD, NAG, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl, SignSGD, Signum),
  those the Trainer runs through its eager loop (Adamax, Nadam, FTML,
  LAMB, LARS, LBSGD, DCASGD, SGLD, ``contrib.GroupAdaGrad``),
  multi-precision master weights and the lr schedulers, updating
  parameters in place;
- ``mx.sym`` — symbol graphs, their JSON, shape inference;
- ``mx.analysis`` — the graph verifier and optimizer (``MXNET_GRAPH_OPT``)
  with the fusion pass;
- ``mx.kernels`` — the flash-attention kernel K1, the decode-attention
  kernel K2, the fused LayerNorm→activation kernel K3, the greedy NMS
  sweep N1, their plain versions and the fused cluster ops;
- ``mx.nd.contrib``/``mx.sym.contrib`` — the detection ops
  (MultiBoxPrior/Target/Detection, ``box_nms``, ``box_iou``,
  ``bipartite_matching``, ``roi_align``) and the eager control flow;
- ``mx.serving`` — InferenceSession (stateless ``predict`` and
  ``load`` of an export, or stateful ``step``), SessionStateStore,
  DynamicBatcher;
- ``mx.rtc`` — ``CudaModule``: CUDA C++ compiled at run time (NVRTC)
  and launched through the driver API on torch's stream (K4);
- ``mx.operator`` — ``CustomOp``/``CustomOpProp`` and ``nd.Custom``;
- ``mx.convert`` — loading weights and optimizer states carried over
  as numpy arrays;
- ``mx.contrib.amp`` — automatic mixed precision (bfloat16 by the op
  lists) and the dynamic loss scaler;
- ``mx.gluon.data``, ``mx.io`` and ``mx.pipeline`` — datasets,
  samplers, the DataLoader, the data iterators and ``DeviceFeed``,
  which stages batches on the card ahead of the step.

- ``mx.sym`` ``simple_bind``/``bind`` → ``mx.executor.Executor``, and
  ``mx.mod`` (``Module``, ``BucketingModule``, ``SequentialModule``,
  ``PythonModule``) with ``mx.metric``, ``mx.callback`` and
  ``mx.model``'s checkpoints: symbolic training, the bound graph's
  forward and backward captured as CUDA graphs on the card;
- ``mx.rnn`` (the symbolic cells, ``BucketSentenceIter``) and
  ``mx.gluon.rnn`` (cells and the fused ``RNN``/``LSTM``/``GRU``
  layers) over the fused ``rnn`` op (cuDNN through torch).

- ``mx.kv``/``mx.kvstore``, ``mx.parallel`` and
  ``mxnet_tpu_torch.tools.launch`` — data parallelism over processes
  (MXNet's ``dist_sync``): the launcher and the rendezvous, the
  collectives over ``torch.distributed`` (NCCL, or gloo where ranks
  share a card or run on the CPU), the kvstore with 2-bit compression
  and its async parameter server, and the distributed ``Trainer``'s
  bucketed gradient all-reduce.

- ``mx.telemetry`` and ``mx.profiler`` — host spans (``MXNET_TELEMETRY``)
  at the seams of dispatch, the fused step, the data pipeline and
  serving, one metrics registry with a Prometheus exposition, and the
  card's trace through ``torch.profiler``; ``mx.runtime``, ``mx.env``
  (the ``MXNET_*`` knob table, ``ENV_VARS.md``), ``mx.log``,
  ``mx.registry``, ``mx.util``, ``mx.misc``, ``mx.libinfo`` and
  ``mx.AttrScope``; the port's locks are ranked
  (``utils/locks.py``, ``MXNET_LOCK_CHECK``).

- ``mx.engine`` and ``mx.storage`` — the dependency engine (native
  lanes of worker threads over versioned vars, ``csrc/engine.cc``) that
  the DataLoader, ``PrefetchingIter``, ``nd.save`` and the record
  iterators push their host work to, and the pooled host storage;
  ``mx.library`` (op libraries), ``mx.ops``, and the trace verifier
  (``mx.analysis.record_trace``/``verify_trace``);
- ``mx.recordio``, ``mx.image`` and ``mx.io.ImageRecordIter`` — RecordIO
  files, the image augmenters and the record iterators, whose JPEG
  decode runs through libjpeg on the host (``csrc/recordio.cc``) or
  nvJPEG and a crop kernel on the card (``csrc/jpeg_decode.cu``);
- ``mx.nd.sparse`` — ``row_sparse`` and ``csr`` arrays, sparse ``dot``,
  the lazy optimizer rows and the store's sparse push and
  ``row_sparse_pull``; ``mx.io.LibSVMIter`` and ``CSVIter`` over the
  text parsers of ``csrc/textio.cc``; the DGL graph ops in
  ``nd.contrib``; ``cpu_shared`` arrays; ``mx.test_utils``.

- ``mx.contrib.onnx`` — ONNX export and import over a wire codec of the
  package's own (no ``protobuf``); ``gluon.contrib.estimator`` (the Fit
  API and its event handlers); ``mx.Monitor``; ``mx.viz``; the model
  store behind the zoo's ``pretrained=True``; the legacy
  ``mx.contrib.{autograd,io,ndarray,symbol}``.

``HybridBlock.hybridize()`` captures a block's forward, and under
``record()`` its backward, as CUDA graphs, one pair per call
signature (``gluon.CachedOp``).

Entry points run on the card: the default context is ``gpu(0)``, and
with no CUDA device they raise :class:`MXNetError` unless the caller
passes ``ctx=mx.cpu()``. The package never imports ``jax`` or
``mxnet_tpu``.

Conventional import: ``import mxnet_tpu_torch as mx``.
"""
from __future__ import annotations

__version__ = "0.1.0"


def _maybe_init_distributed():
    """Join the process group when the launcher's environment is present
    (``tools/launch.py``: ``MXNET_COORDINATOR`` and the rank variables),
    as the JAX package joins at import (``mxnet_tpu/__init__.py:21-86``);
    a failed rendezvous raises."""
    from . import _rendezvous

    _rendezvous.init()


_maybe_init_distributed()

from .base import MXNetError  # noqa: E402
from .context import Context, cpu, current_context, gpu, num_gpus  # noqa: E402,E501
from . import autograd  # noqa: E402
from . import initializer
from . import initializer as init
from . import ndarray
from . import ndarray as nd
from . import random
from . import optimizer
from . import gluon
from . import kernels
from . import name
from . import symbol
from . import symbol as sym
from . import analysis
from . import models
from . import serving
from . import convert
from . import operator
from . import rtc
from . import contrib
from . import io
from . import pipeline
from . import metric
from . import callback
from . import model
from . import executor
from . import module
from . import module as mod
from . import rnn
from . import utils
from . import parallel
from . import gradient_compression
from . import kvstore
from . import kvstore as kv
from . import env
from . import telemetry
from . import profiler
from . import runtime
from . import log
from . import registry
from . import util
from . import misc
from . import libinfo
from . import attribute
from .attribute import AttrScope
from . import engine
from . import storage
from . import library
from . import ops
from . import recordio
from . import image
from . import test_utils
from . import monitor
from .monitor import Monitor
from . import visualization
from . import visualization as viz
from . import initialize as _initialize

# crash tracebacks and a fork-safe engine (reference: src/initialize.cc),
# where the JAX package installs them (``mxnet_tpu/__init__.py:114``)
_initialize.initialize()

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "autograd", "initializer", "init", "ndarray", "nd",
           "random", "optimizer", "gluon", "kernels", "name", "symbol", "sym",
           "analysis", "models", "serving", "convert", "operator", "rtc",
           "contrib", "io", "pipeline", "metric", "callback", "model",
           "executor", "module", "mod", "rnn", "utils", "parallel",
           "gradient_compression", "kvstore", "kv", "env", "telemetry",
           "profiler", "runtime", "log", "registry", "util", "misc",
           "libinfo", "attribute", "AttrScope", "engine", "storage",
           "library", "ops", "recordio", "image", "test_utils", "monitor",
           "Monitor", "visualization", "viz"]

# the env knobs applied once at import, as the JAX package applies them
# (``mxnet_tpu/__init__.py:160-168``): the global seed, the profiler's
# autostart, then a warning for every unknown MXNET_* variable
if env.get_str("MXNET_SEED"):
    random.seed(env.get_int("MXNET_SEED", 0))
if env.get_bool("MXNET_PROFILER_AUTOSTART"):
    profiler.set_config(aggregate_stats=True)
    profiler.start()
env.check()
