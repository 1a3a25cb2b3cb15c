"""Operator performance harness (reference: benchmark/opperf/):
``mxnet_tpu_torch.benchmark.opperf``."""
