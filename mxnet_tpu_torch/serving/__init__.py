"""mxnet_tpu_torch.serving — stateful decode serving.

The PyTorch counterpart of ``mxnet_tpu.serving``, cut to the stateful
decode path:

- :class:`~.session.InferenceSession` — eval-mode decode step padded to
  occupancy buckets; :meth:`~.session.InferenceSession.step` with
  explicit states.
- :class:`~.state.SessionStateStore` — one preallocated device tensor
  per state row, slot-indexed; TTL + LRU eviction
  (:class:`~.state.SessionEvicted`).
- :class:`~.batcher.DynamicBatcher` — the continuous-batching step loop:
  ``submit(*inputs, session_id=)`` returns a Future of numpy.
- :mod:`~.metrics` — the serving counters (:data:`~.metrics.METRICS`).
"""
from .batcher import DynamicBatcher, RequestTimeout, ServerBusy
from .metrics import METRICS
from .session import InferenceSession
from .state import SessionEvicted, SessionStateStore

__all__ = ["InferenceSession", "DynamicBatcher",
           "ServerBusy", "RequestTimeout", "SessionStateStore",
           "SessionEvicted", "METRICS"]
