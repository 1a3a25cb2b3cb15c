"""Fused recurrent layers.

The PyTorch counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``
(reference: python/mxnet/gluon/rnn/rnn_layer.py, RNN/LSTM/GRU over the
fused RNN op). The parameters keep the reference's per-layer and
per-direction names (``l0_i2h_weight``, ``r0_h2h_bias``, ...), so
checkpoints interchange; each forward packs them into the fused op's
vector (one concatenation), and the op runs torch's fused RNN (cuDNN on
the card) over views of it. Hybridized, a layer's forward and backward
are captured as CUDA graphs (``CachedOp``), states included.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][:self._dir]:
                    self._register_param(f"{j}{i}_i2h_weight",
                                         (ng * nh, ni if i == 0 else
                                          nh * self._dir),
                                         i2h_weight_initializer)
                    self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                         h2h_weight_initializer)
                    self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                         i2h_bias_initializer)
                    self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                         h2h_bias_initializer)

    def _register_param(self, name, shape, init):
        if self._input_size == 0 and "i2h_weight" in name and \
                name.startswith(("l0", "r0")):
            shape = (shape[0], 0)
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def infer_param_shapes(self, x, *args):
        ni = x.shape[-1]
        self._input_size = ni
        for j in ["l", "r"][:self._dir]:
            p = getattr(self, f"{j}0_i2h_weight")
            p.shape = (self._gates * self._hidden_size, ni)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (reference: rnn_layer.py begin_state)."""
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            states.append(func(info["shape"], **kwargs))
        return states

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)
        batch_size = inputs.shape[1]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, nd.NDArray):
            states = [states]
        # pack parameters in cuDNN order: all weights, then all biases
        weights, biases = [], []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                weights.append(params[f"{j}{i}_i2h_weight"].reshape((-1,)))
                weights.append(params[f"{j}{i}_h2h_weight"].reshape((-1,)))
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                biases.append(params[f"{j}{i}_i2h_bias"])
                biases.append(params[f"{j}{i}_h2h_bias"])
        packed = F.concat(*(weights + biases), dim=0)
        out = F.rnn(inputs, packed, states[0],
                    states[1] if self._mode == "lstm" else None,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        outputs, out_states = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, 0, 1)
        if skip_states:
            return outputs
        return outputs, out_states


class RNN(_RNNLayer):
    """Reference: rnn_layer.py RNN (vanilla Elman, relu/tanh)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Reference: rnn_layer.py LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", projection_size,
                         **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Reference: rnn_layer.py GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
