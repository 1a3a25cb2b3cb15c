"""Convolution and pooling Gluon layers.

The PyTorch counterparts of ``mxnet_tpu/gluon/nn/conv_layers.py:24-305``
(reference: python/mxnet/gluon/nn/conv_layers.py): ``Conv1D``-``Conv3D``
over the ``convolution`` op (cuDNN on the card), their transposes
``Conv1DTranspose``-``Conv3DTranspose`` over ``deconvolution``, the max,
average and global pooling layers over the ``pooling`` op, and
``ReflectionPad2D`` over ``pad``. A channel-last layout (NWC, NHWC,
NDHWC) stores the filter as (O, *k, I/g), as the JAX package does; a
transposed convolution takes channel-first layouts only and stores its
filter as (I, O/g, *k), MXNet's layout and torch's.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_CHANNEL_LAST = ("NWC", "NHWC", "NDHWC")


def _tuplize(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """Reference: conv_layers.py _Conv. ``in_channels=0`` defers the
    weight's input-channel size to the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        nd_ = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._stride = _tuplize(strides, nd_)
        self._pad = _tuplize(padding, nd_)
        self._dilate = _tuplize(dilation, nd_)
        self._groups = groups
        self._layout = layout
        self._channel_last = layout in _CHANNEL_LAST
        ic = in_channels // groups if in_channels else 0
        wshape = ((channels,) + kernel_size + (ic,)) if self._channel_last \
            else ((channels, ic) + kernel_size)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None
            self.act = Activation(activation) if activation else None

    def infer_param_shapes(self, x, *args):
        in_c = x.shape[-1] if self._channel_last else x.shape[1]
        if self._channel_last:
            self.weight.shape = (self._channels,) + self._kernel + \
                (in_c // self._groups,)
        else:
            self.weight.shape = (self._channels, in_c // self._groups) + \
                self._kernel

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.convolution(x, weight, bias, kernel=self._kernel,
                            stride=self._stride, dilate=self._dilate,
                            pad=self._pad, num_filter=self._channels,
                            num_group=self._groups, no_bias=bias is None,
                            layout=self._layout)
        if self.act is not None:
            out = self.act(out)
        return out

    def extra_repr(self):
        return f"{self._channels}, kernel_size={self._kernel}, " \
               f"stride={self._stride}"


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class _ConvTranspose(_Conv):
    """Reference: conv_layers.py _Conv with op_name Deconvolution.
    ``output_padding`` is the op's ``adj``: rows and columns added on the
    high side of the output."""

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        if layout in _CHANNEL_LAST:
            raise ValueError("transposed convolution supports channel-first "
                             "layouts only (NCW/NCHW/NCDHW)")
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)
        self._adj = _tuplize(output_padding, len(kernel_size))
        self.weight._shape = (in_channels if in_channels else 0,
                              channels // groups) + tuple(kernel_size)

    def infer_param_shapes(self, x, *args):
        self.weight.shape = (x.shape[1], self._channels // self._groups) + \
            self._kernel

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.deconvolution(x, weight, bias, kernel=self._kernel,
                              stride=self._stride, dilate=self._dilate,
                              pad=self._pad, adj=self._adj,
                              num_filter=self._channels,
                              num_group=self._groups, no_bias=bias is None)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 1), strides, padding,
                         output_padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 2), strides, padding,
                         output_padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 3), strides, padding,
                         output_padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    """Reference: conv_layers.py _Pooling; ``ceil_mode`` is the op's
    ``pooling_convention="full"``."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, layout=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kernel = pool_size
        self._stride = _tuplize(strides if strides is not None else pool_size,
                                len(pool_size)) if pool_size else None
        self._pad = _tuplize(padding, len(pool_size)) if pool_size else None
        self._ceil = ceil_mode
        self._global = global_pool
        self._type = pool_type
        self._count_include_pad = count_include_pad
        self._layout = layout

    def hybrid_forward(self, F, x):
        kw = {}
        if self._count_include_pad is not None:
            kw["count_include_pad"] = self._count_include_pad
        return F.pooling(x, kernel=self._kernel, pool_type=self._type,
                         global_pool=self._global, stride=self._stride,
                         pad=self._pad,
                         pooling_convention="full" if self._ceil else "valid",
                         layout=self._layout, **kw)

    def extra_repr(self):
        return f"size={self._kernel}, stride={self._stride}, " \
               f"padding={self._pad}"


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout=layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout=layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout=layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tuplize(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, layout=layout,
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplize(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, layout=layout,
                         **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplize(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, layout=layout,
                         **kwargs)


class _GlobalPooling(_Pooling):
    def __init__(self, pool_type, layout=None, **kwargs):
        super().__init__((1,), None, 0, False, True, pool_type,
                         layout=layout, **kwargs)

    def extra_repr(self):
        return ""


class GlobalMaxPool1D(_GlobalPooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__("max", layout=layout, **kwargs)


class GlobalMaxPool2D(_GlobalPooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__("max", layout=layout, **kwargs)


class GlobalMaxPool3D(_GlobalPooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__("max", layout=layout, **kwargs)


class GlobalAvgPool1D(_GlobalPooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__("avg", layout=layout, **kwargs)


class GlobalAvgPool2D(_GlobalPooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__("avg", layout=layout, **kwargs)


class GlobalAvgPool3D(_GlobalPooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__("avg", layout=layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Pads the two spatial axes of NCHW data by reflection (reference:
    conv_layers.py ReflectionPad2D); an int pads all four sides."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
