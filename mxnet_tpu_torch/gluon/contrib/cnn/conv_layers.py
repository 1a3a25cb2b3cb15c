"""The deformable convolution Gluon layer (reference:
python/mxnet/gluon/contrib/cnn/conv_layers.py DeformableConvolution).

The PyTorch counterpart of
``mxnet_tpu/gluon/contrib/cnn/conv_layers.py``: one layer owning both
convolutions of Deformable ConvNets v1, a regular one that makes each
tap's (dy, dx) offsets (zero-initialized, so training starts on the
regular grid) and the deformable one that reads them
(``nd.contrib.deformable_convolution``). Its parameters are the JAX
layer's, name for name (``weight``, ``bias``, ``offset_weight``,
``offset_bias``), so ``convert.params_from_numpy`` carries a JAX
layer's weights across.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn.basic_layers import Activation

__all__ = ["DeformableConvolution"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class DeformableConvolution(HybridBlock):
    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, layout="NCHW", use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout != "NCHW":
            raise ValueError("deformable_convolution runs NCHW (the "
                             "reference kernel's layout)")
        kernel_size = _pair(kernel_size)
        self._channels = channels
        common = {"kernel": kernel_size, "stride": _pair(strides),
                  "dilate": _pair(dilation), "pad": _pair(padding),
                  "num_group": groups, "layout": layout}
        self._kwargs_offset = dict(common, num_filter=2 * kernel_size[0]
                                   * kernel_size[1] * num_deformable_group)
        self._kwargs_conv = dict(common, num_filter=channels,
                                 num_deformable_group=num_deformable_group)
        ic = in_channels // groups if in_channels else 0
        n_off = self._kwargs_offset["num_filter"]
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, ic) + kernel_size,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer) \
                if use_bias else None
            self.offset_weight = self.params.get(
                "offset_weight", shape=(n_off, ic) + kernel_size,
                init=offset_weight_initializer, allow_deferred_init=True)
            self.offset_bias = self.params.get(
                "offset_bias", shape=(n_off,),
                init=offset_bias_initializer) if offset_use_bias else None
            self.act = Activation(activation) if activation else None

    def infer_param_shapes(self, x, *args):
        ic = x.shape[1] // self._kwargs_conv["num_group"]
        k = self._kwargs_conv["kernel"]
        self.weight.shape = (self._channels, ic) + k
        self.offset_weight.shape = (self._kwargs_offset["num_filter"],
                                    ic) + k

    def hybrid_forward(self, F, x, weight, offset_weight, bias=None,
                       offset_bias=None):
        offset = F.convolution(x, offset_weight, offset_bias,
                               no_bias=offset_bias is None,
                               **self._kwargs_offset)
        out = F.contrib.deformable_convolution(
            x, offset, weight, bias, no_bias=bias is None,
            **self._kwargs_conv)
        if self.act is not None:
            out = self.act(out)
        return out
