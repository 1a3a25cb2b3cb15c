"""Symbolic RNN cells.

The PyTorch counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference:
python/mxnet/rnn/rnn_cell.py). These build Symbol graphs (the pre-Gluon
API the reference keeps for Module and bucketing users); the Gluon cells
in ``gluon/rnn`` are their eager and hybrid counterparts. An unrolled
graph runs through a bound executor, which captures the whole unrolled
step on the card as one CUDA graph per bucket. ``FusedRNNCell.unroll``
unfuses into the stacked cells, as the JAX package does.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "FusedRNNCell"]


class BaseRNNCell:
    """Reference: rnn_cell.py:BaseRNNCell."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._counter = -1
        self._init_counter = -1
        self._modified = False

    @property
    def state_info(self):
        raise NotImplementedError

    def state_row_shapes(self):
        """Per-state PER-ROW shapes (batch axis dropped) — what a
        serving :class:`~mxnet_tpu_torch.serving.state.SessionStateStore`
        needs as its ``state_shapes``: the symbolic ``state_info``
        shapes lead with the 0 batch placeholder."""
        return [tuple(info["shape"][1:]) for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def reset(self):
        self._counter = -1
        self._init_counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    def _var(self, name):
        return sym.Variable(self._prefix + name)

    def begin_state(self, func=None, **kwargs):
        """Initial-state symbols (reference rnn_cell.py begin_state)."""
        states = []
        for info in self.state_info:
            self._init_counter += 1
            states.append(sym.Variable(
                f"{self._prefix}begin_state_{self._init_counter}"))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll over `length` steps (reference rnn_cell.py:unroll).

        inputs: one Symbol (N,T,C) split on the time axis, or a list of
        per-step Symbols. Returns (outputs, final_states)."""
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, sym.Symbol):
            inputs = list(sym.split(inputs, num_outputs=length,
                                    axis=axis, squeeze_axis=True))
        assert len(inputs) == length
        states = begin_state if begin_state is not None \
            else self.begin_state()
        outputs = []
        for t in range(length):
            out, states = self(inputs[t], states)
            outputs.append(out)
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Elman RNN cell (reference rnn_cell.py:RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self._var("i2h_weight")
        self._iB = self._var("i2h_bias")
        self._hW = self._var("h2h_weight")
        self._hB = self._var("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name=name + "i2h")
        h2h = sym.FullyConnected(states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden,
                                 name=name + "h2h")
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name=name + "out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference rnn_cell.py:LSTMCell; gate order i,f,c,o).

    ``forget_bias`` is an INITIALIZATION hint, exposed as
    ``bias_init_value()``: the reference seeds the forget-gate slice of
    h2h_bias with it via the LSTMBias initializer; in this symbolic API
    the caller owns parameter values at bind time, so seed your
    h2h_bias with ``bias_init_value()`` to reproduce that behavior (the
    gate math itself is identical either way)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias
        self._iW = self._var("i2h_weight")
        self._iB = self._var("i2h_bias")
        self._hW = self._var("h2h_weight")
        self._hB = self._var("h2h_bias")

    def bias_init_value(self):
        """h2h_bias seed honoring forget_bias (reference LSTMBias
        initializer, python/mxnet/initializer.py:LSTMBias)."""
        import numpy as onp

        b = onp.zeros(4 * self._num_hidden, "float32")
        b[self._num_hidden:2 * self._num_hidden] = self._forget_bias
        return b

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        nh = self._num_hidden
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=nh * 4, name=name + "i2h")
        h2h = sym.FullyConnected(states[0], weight=self._hW,
                                 bias=self._hB, num_hidden=nh * 4,
                                 name=name + "h2h")
        gates = i2h + h2h
        sl = list(sym.split(gates, num_outputs=4, axis=-1))
        in_gate = sym.Activation(sl[0], act_type="sigmoid")
        forget_gate = sym.Activation(sl[1], act_type="sigmoid")
        in_trans = sym.Activation(sl[2], act_type="tanh")
        out_gate = sym.Activation(sl[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.Activation(next_c, act_type="tanh",
                                           name=name + "state")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference rnn_cell.py:GRUCell; gate order r,z,n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._iW = self._var("i2h_weight")
        self._iB = self._var("i2h_bias")
        self._hW = self._var("h2h_weight")
        self._hB = self._var("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        nh = self._num_hidden
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=nh * 3, name=name + "i2h")
        h2h = sym.FullyConnected(states[0], weight=self._hW,
                                 bias=self._hB, num_hidden=nh * 3,
                                 name=name + "h2h")
        i_r, i_z, i_n = list(sym.split(i2h, num_outputs=3, axis=-1))
        h_r, h_z, h_n = list(sym.split(h2h, num_outputs=3, axis=-1))
        reset = sym.Activation(i_r + h_r, act_type="sigmoid")
        update = sym.Activation(i_z + h_z, act_type="sigmoid")
        trans = sym.Activation(i_n + reset * h_n, act_type="tanh")
        next_h = update * states[0] + (1.0 - update) * trans
        return next_h, [next_h]


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells (reference rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__("", params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def reset(self):
        super().reset()
        for c in self._cells:
            c.reset()


class DropoutCell(BaseRNNCell):
    """Reference: rnn_cell.py:DropoutCell."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def begin_state(self, **kwargs):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = sym.Dropout(inputs, p=self.dropout)
        return inputs, states


class BidirectionalCell(BaseRNNCell):
    """Reference: rnn_cell.py:BidirectionalCell — unroll-only."""

    def __init__(self, l_cell, r_cell, params=None,
                 output_prefix="bi_"):
        super().__init__("", params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, **kwargs):
        return (self._l_cell.begin_state(**kwargs) +
                self._r_cell.begin_state(**kwargs))

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll "
            "(reference rnn_cell.py:1186)")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, sym.Symbol):
            inputs = list(sym.split(inputs, num_outputs=length,
                                    axis=axis, squeeze_axis=True))
        states = begin_state if begin_state is not None \
            else self.begin_state()
        nl = len(self._l_cell.state_info)
        l_out, l_states = self._l_cell.unroll(
            length, inputs, states[:nl], layout, merge_outputs=False)
        r_out, r_states = self._r_cell.unroll(
            length, list(reversed(inputs)), states[nl:], layout,
            merge_outputs=False)
        outputs = [sym.concat(lo, ro, dim=-1,
                              name=f"{self._output_prefix}t{t}")
                   for t, (lo, ro) in enumerate(
                       zip(l_out, reversed(r_out)))]
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, l_states + r_states


class FusedRNNCell(BaseRNNCell):
    """A multi-layer RNN (reference rnn_cell.py:FusedRNNCell); as in the
    JAX package, ``unroll`` goes through ``unfuse()``, the equivalent
    stacked cells."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix="rnn_",
                 params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout

    @property
    def state_info(self):
        d = 2 if self._bidirectional else 1
        info = [{"shape": (self._num_layers * d, 0, self._num_hidden)}]
        if self._mode == "lstm":
            info.append(
                {"shape": (self._num_layers * d, 0, self._num_hidden)})
        return info

    def unfuse(self):
        cells = SequentialRNNCell()
        ctor = {"rnn_tanh": lambda p: RNNCell(
                    self._num_hidden, "tanh", prefix=p),
                "rnn_relu": lambda p: RNNCell(
                    self._num_hidden, "relu", prefix=p),
                "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
                "gru": lambda p: GRUCell(self._num_hidden, prefix=p)}[
            self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                cells.add(BidirectionalCell(
                    ctor(f"{self._prefix}l{i}_"),
                    ctor(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                cells.add(ctor(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                cells.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return cells

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        return self.unfuse().unroll(length, inputs, begin_state, layout,
                                    merge_outputs)
