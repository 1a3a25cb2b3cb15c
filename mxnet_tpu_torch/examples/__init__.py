"""Twins of the repository's ``examples/`` scripts, written against the
port: the same code with ``mxnet_tpu_torch`` for ``mxnet_tpu``, on the
card unless ``--cpu`` is given. Run one with ``python -m
mxnet_tpu_torch.examples.<name>``."""
