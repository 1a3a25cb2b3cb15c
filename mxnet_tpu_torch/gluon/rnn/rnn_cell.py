"""Recurrent cells.

The PyTorch counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``
(reference: python/mxnet/gluon/rnn/rnn_cell.py — the cells, the
Sequential/Bidirectional/Residual/Dropout/Zoneout wrappers, ``unroll``).
``unroll`` is a Python loop over the steps, as in the JAX package; the
fused layers (``rnn_layer.py``) run the whole sequence in one op. The
initial states ``unroll`` makes live where the inputs do.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


class RecurrentCell(HybridBlock):
    """Reference: rnn_cell.py RecurrentCell."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if hasattr(cell, "reset"):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def state_row_shapes(self):
        """Per-state PER-ROW shapes (batch axis dropped) — the
        ``state_shapes`` a stateful serving session or
        :class:`~mxnet_tpu_torch.serving.state.SessionStateStore` wants
        for this cell."""
        return [tuple(info["shape"][1:])
                for info in self.state_info(0)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info = {k: v for k, v in info.items() if k == "shape"}
                states.append(func(**info, **kwargs))
            else:
                states.append(func(shape=(0,), **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Reference: rnn_cell.py unroll."""
        self.reset()
        axis = layout.find("T")
        batch_axis = layout.find("N")
        if isinstance(inputs, nd.NDArray):
            ctx = inputs.context
            batch_size = inputs.shape[batch_axis]
            inputs = nd.split(inputs, num_outputs=length, axis=axis,
                              squeeze_axis=True)
            if length == 1:
                inputs = [inputs] if isinstance(inputs, nd.NDArray) \
                    else list(inputs)
            else:
                inputs = list(inputs)
        else:
            ctx = inputs[0].context
            batch_size = inputs[0].shape[batch_axis - 1 if batch_axis > axis
                                         else batch_axis]
        if begin_state is None:
            # by keyword: a sequential or modifier cell's begin_state
            # takes no positional batch size
            begin_state = self.begin_state(batch_size=batch_size, ctx=ctx)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if valid_length is not None:
            stacked = nd.stack(*outputs, axis=axis)
            stacked = nd.sequence_mask(
                nd.swapaxes(stacked, 0, axis) if axis != 0 else stacked,
                sequence_length=valid_length, use_sequence_length=True)
            if axis != 0:
                stacked = nd.swapaxes(stacked, 0, axis)
            outputs = stacked
            if merge_outputs is False:
                outputs = [o.squeeze(axis=axis)
                           for o in nd.split(outputs, length, axis=axis)]
        elif merge_outputs or merge_outputs is None and False:
            outputs = nd.stack(*outputs, axis=axis)
        elif merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        if merge_outputs and not isinstance(outputs, nd.NDArray):
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, x, states):
        self._counter += 1
        return super().forward(x, states)


class HybridRecurrentCell(RecurrentCell):
    pass


class RNNCell(HybridRecurrentCell):
    """Elman cell (reference: rnn_cell.py RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(hidden_size, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_param_shapes(self, x, *args):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.fully_connected(inputs, i2h_weight, i2h_bias,
                                num_hidden=self._hidden_size)
        h2h = F.fully_connected(states[0], h2h_weight, h2h_bias,
                                num_hidden=self._hidden_size)
        output = F.activation(i2h + h2h, act_type=self._activation) \
            if self._activation in ("relu", "tanh", "sigmoid", "softrelu") \
            else getattr(F, self._activation)(i2h + h2h)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """Reference: rnn_cell.py LSTMCell (gate order i,f,g,o — cuDNN compat)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def infer_param_shapes(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.fully_connected(inputs, i2h_weight, i2h_bias,
                                num_hidden=4 * self._hidden_size)
        h2h = F.fully_connected(states[0], h2h_weight, h2h_bias,
                                num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        in_gate, forget_gate, in_trans, out_gate = \
            F.split(gates, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(in_gate)
        forget_gate = F.sigmoid(forget_gate)
        in_trans = F.tanh(in_trans)
        out_gate = F.sigmoid(out_gate)
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """Reference: rnn_cell.py GRUCell (gate order r,z,n — cuDNN compat)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(3 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(3 * hidden_size, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(3 * hidden_size,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(3 * hidden_size,),
                init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_param_shapes(self, x, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.fully_connected(inputs, i2h_weight, i2h_bias,
                                num_hidden=3 * self._hidden_size)
        h2h = F.fully_connected(prev_state_h, h2h_weight, h2h_bias,
                                num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h = F.split(h2h, num_outputs=3, axis=-1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h + reset_gate * h2h)
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Reference: rnn_cell.py SequentialRNNCell."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)


class DropoutCell(HybridRecurrentCell):
    """Reference: rnn_cell.py DropoutCell."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + "modifier_")
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func or nd.zeros, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Reference: rnn_cell.py ZoneoutCell."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        mask = lambda p, like: F.dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(self.zoneout_outputs, next_output), next_output,
                         prev_output) if self.zoneout_outputs > 0. \
            else next_output
        new_states = [F.where(mask(self.zoneout_states, ns), ns, s)
                      for ns, s in zip(next_states, states)] \
            if self.zoneout_states > 0. else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Reference: rnn_cell.py ResidualCell."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class BidirectionalCell(HybridRecurrentCell):
    """Reference: rnn_cell.py BidirectionalCell."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, nd.NDArray):
            seq = [s for s in nd.split(inputs, length, axis=axis,
                                       squeeze_axis=True)] if length > 1 else \
                [inputs.squeeze(axis=axis)]
        else:
            seq = list(inputs)
        l_cell, r_cell = self._children.values()
        batch_size = seq[0].shape[0]
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=seq[0].context)
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, seq, begin_state[:n_l], layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, list(reversed(seq)), begin_state[n_l:], layout,
            merge_outputs=False)
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
